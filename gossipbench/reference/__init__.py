"""The plain reference the benchmark's check holds the program to.

Plain PyTorch and nothing of the program: ``prng`` (the random
streams), ``model`` (the protocol period and the three engines) and one
file per engine the cells drive (``kernel_runner``, ``live``,
``lanes``), each with ``call(state, key, P, traffic, scalars0, F)`` ->
``(state, trace or None, scalars or None)``. The harness finds an
engine's file by the name a traffic file gives under ``reference``.
"""
