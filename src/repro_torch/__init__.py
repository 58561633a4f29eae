"""PyTorch/CUDA port of the `repro` package for NVIDIA Hopper.

The JAX package (`repro`) stays the reference; this package imports
nothing of it. Its layout mirrors the reference (`configs/`, `kernels/`,
`core/`, `models/`, `serving/`, `launch/`), and every Pallas kernel on
the ported path is a hand-written CUDA C++ kernel under
`kernels/csrc/`, built at first use with `nvcc` and bound with ctypes.

Entry points run on the card (`device=None` means `"cuda"`) and raise
where there is none, unless the caller passes `device="cpu"`: a kernel
wrapper then runs the kernel's plain PyTorch version, because the
tensor it was given lies on the CPU.
"""
