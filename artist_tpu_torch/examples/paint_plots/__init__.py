"""The PAINT plot example of ``examples/paint_plots/`` as importable modules.

Each script keeps its JAX counterpart's file name and runs as
``python -m artist_tpu_torch.examples.paint_plots.<script>`` (``INSTRUCTIONS.md``).
Every stage is a function on a scenario, a calibration parser and a ``device`` in
memory; the command line reads and writes the files around it.
"""
