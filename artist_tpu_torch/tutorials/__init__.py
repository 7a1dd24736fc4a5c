"""The tutorials of ``tutorials/`` as importable modules: each stage a function on in-memory inputs, each
``main(argv)`` a command line that does the file I/O."""
