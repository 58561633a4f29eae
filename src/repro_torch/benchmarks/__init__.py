"""The port's twins of the JAX package's paper benchmarks
(`benchmarks/bench_matmul.py`, `bench_shared_memory.py`, `bench_add.py`):
Table 2 / Fig 7, Fig 8 and Fig 9, measured on the card (or, with
`--device cpu`, through the plain versions on the CPU) beside the
roofline model of the paper's cards and of the H100.
"""
