"""What the serving engine and the speculative draft share: their
weights placed on the device once, and a step captured in a CUDA graph.

A step (`CapturedStep`) is a function that reads and writes only tensors
its owner keeps for its life (the params, a cache, static token and
position tensors that the owner fills with `copy_` before each call). On
the card it is captured once and each call replays it: one launch where
eager PyTorch dispatches thousands of ops, the counterpart of the JAX
engine's jitted steps. On the CPU the owner calls the function itself.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops

# Eager runs of a step on a side stream before its capture: the first
# builds and loads the kernels and sets their attributes, host work that
# a capture must not see.
WARMUP_RUNS = 2


#: The leaves `place_params` casts to the compute dtype: float matrix
#: weights, a hybrid's LoRA pairs and the MoE expert banks (raw tensors
#: under the keys a SwiGLU MLP keeps its weight dicts at).
_CAST = ("w", "lora_a", "lora_b", "w_gate", "w_up", "w_down")
#: The subtrees it leaves in their own dtype: the MoE router, which the
#: reference runs in f32 on f32 activations.
_KEEP = ("router",)


def place_params(tree, device, dtype):
    """The params on `device`, float matrix weights ("w" leaves, a
    hybrid's "lora_a" / "lora_b", the MoE banks) in the compute dtype;
    norm scales, the int8 weights' leaves ("w_q" int8, "w_scale" f32) and
    the MoE router as they are. The JAX package casts each weight to the
    activation dtype on every call (the router's to f32); casting once
    here gives the same values."""
    return {k: (on_device(v, device) if k in _KEEP
                else place_params(v, device, dtype))
            if isinstance(v, dict)
            else v.to(device, dtype if k in _CAST else v.dtype)
            for k, v in tree.items()}


def on_device(tree, device):
    return {k: on_device(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


class CapturedStep:
    """`fn()` captured in a CUDA graph on `device`, the counterpart of a
    jitted step. `fn` reads and writes only tensors that outlive the
    graph (the params, a cache, static inputs). Calling this replays on
    the current stream the kernels `fn` launched, against the same
    tensors, and returns the tensor `fn` returned, which the replay
    rewrites. A replay calls no kernel wrapper, so it adds the launches
    that the capture counted to `ops.launch_counts()`; the counts of the
    warm-up runs and of the capture itself are taken out. Raises
    RuntimeError when `fn` cannot be captured: nothing falls back to
    running it eagerly. `release()` frees the graph and its pool, so a
    step can be captured again without keeping the old one."""

    def __init__(self, fn, device, what: str):
        start = kops.launch_counts()
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        try:
            with torch.cuda.stream(side):
                for _ in range(WARMUP_RUNS):
                    fn()
            torch.cuda.synchronize(device)
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(device)
            warm = kops.launch_counts()
            self.graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.stream(side):
                    self.graph.capture_begin()
                    try:
                        self.out = fn()
                    except BaseException:
                        _end_broken_capture(self.graph)
                        raise
                    self.graph.capture_end()
            except RuntimeError as e:
                raise RuntimeError(
                    f"capturing {what} in a CUDA graph failed: the step "
                    f"must launch its work on the current stream with no "
                    f"host sync (.item(), .cpu(), a shape that depends on "
                    f"the data, torch.cuda.synchronize); the cause is "
                    f"above") from e
        finally:
            done = kops.launch_counts()
            kops.add_launch_counts({k: start[k] - n for k, n in done.items()})
        self.launches = {k: done[k] - warm[k] for k in done
                         if done[k] != warm[k]}
        self.pool_bytes = torch.cuda.memory_reserved(device) - reserved

    def __call__(self) -> torch.Tensor:
        self.graph.replay()
        kops.add_launch_counts(self.launches)
        return self.out

    def release(self) -> None:
        """Free the graph and the memory of its private pool (the output
        tensor lives there); the step cannot be called after."""
        self.out = None
        self.graph.reset()
        self.graph = None
        self.pool_bytes = 0


def _end_broken_capture(graph) -> None:
    """End a capture that an error in the captured code broke. The caller
    raises that error on; capture_end's own, that the capture is invalid,
    says nothing more, so it is dropped."""
    try:
        graph.capture_end()
    except RuntimeError:
        pass
