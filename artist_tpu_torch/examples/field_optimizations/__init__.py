"""The field-optimization example of ``examples/field_optimizations/`` as importable modules.

``config.yaml`` beside them is the port's copy of the example's configuration;
every module's functions take it as a dict (:func:`generate_scenarios.load_config`).
"""
