"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``).

One run drives one cell: a configuration's fields made on the card from the
seed, a simulation time loop through the port's entry point for a fixed
number of seconds, the timed path's own outputs held against a frozen plain
reference, and one JSON line of results.  ``python -m portbench.run --help``
gives the command line; ``BENCHMARK.json`` names the cells and metrics, and
each lives in a file of its own under this folder.
"""
