"""The plain references that decide ``correct``.

Each module here computes what a configuration's entry computes, from the
same int16 inputs, with plain PyTorch on whatever device holds them.  It
imports neither JAX nor anything of the program under test
(``tests/test_bench_imports.py`` holds it to that)."""
