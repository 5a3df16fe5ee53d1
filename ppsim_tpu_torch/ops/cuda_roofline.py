"""The roofline probes' kernels and their plain twins (port of the two
Pallas kernel bodies of ``bench/mfu.py``).

- :func:`fma_chain_cuda` launches ``fma_chain`` (``csrc/roofline.cu``; it
  replaces the FMA-chain kernel of ``vpu_peak_flops``): elementwise on
  ``a = x``, ``b = a * 1.0000001 + 0.5``, ``chains`` accumulators start at
  ``a + k`` and take ``iters`` steps ``acc = acc * b + a``; the output is
  their sum, left to right. Plain twin :func:`fma_chain_plain`, which rounds
  each product and sum apart where the kernel's FFMA rounds once: about an
  ulp a step apart.
- :func:`stream_add_cuda` launches ``stream_add`` (the same file; it
  replaces the stream copy of ``hbm_stream_bw``): ``x + 1``. Plain twin
  :func:`stream_add_plain`, bitwise equal.

On CUDA tensors a wrapper launches its kernel; on CPU tensors it runs the
plain twin; a tensor on any other device raises. There is no fallback from
a kernel to the plain version. Both take ``out``, a float32 tensor of
``x``'s shape to write (fresh when None), so that a chain of calls can
ping-pong two buffers.
"""

from __future__ import annotations

import torch

from ppsim_tpu_torch import _build

__all__ = ["fma_chain_cuda", "fma_chain_plain", "stream_add_cuda", "stream_add_plain",
           "FMA_CHAINS"]

# The kernel's instances of the chain count (a template parameter).
FMA_CHAINS = (1, 2, 4, 8)
# b = a * B_SCALE + B_SHIFT, as the TPU kernel writes it; float32 constants.
B_SCALE, B_SHIFT = 1.0000001, 0.5


def _out_like(x, out):
    if out is None:
        return torch.empty_like(x, memory_format=torch.contiguous_format)
    if out.shape != x.shape or out.dtype != torch.float32 or out.device != x.device:
        raise ValueError(f"out must be float32 {tuple(x.shape)} on {x.device}, got "
                         f"{out.dtype} {tuple(out.shape)} on {out.device}")
    if not out.is_contiguous():
        raise ValueError("out must be contiguous")
    return out


def _check_input(x) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"expected a CUDA or CPU tensor, got {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"expected float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("expected a contiguous tensor")


def fma_chain_plain(x, iters: int, chains: int, out=None):
    """The FMA chain in plain torch, every product and sum rounded apart."""
    if x.dtype != torch.float32:
        raise TypeError(f"expected float32, got {x.dtype}")
    scale = torch.tensor(B_SCALE, dtype=torch.float32, device=x.device)
    b = x * scale + B_SHIFT
    accs = [x + float(k) for k in range(chains)]
    for _ in range(iters):
        accs = [acc * b + x for acc in accs]
    y = accs[0]
    for acc in accs[1:]:
        y = y + acc
    if out is None:
        return y
    return _out_like(x, out).copy_(y)


def fma_chain_cuda(x, iters: int, chains: int, out=None):
    """The FMA chain: CUDA tensors launch ``fma_chain``
    (``fma_chain_cuda.launches`` counts the launches); CPU tensors run
    :func:`fma_chain_plain`. ``chains`` is one of :data:`FMA_CHAINS`."""
    if x.device.type == "cpu":
        return fma_chain_plain(x, iters, chains, out)
    _check_input(x)
    if chains not in FMA_CHAINS:
        raise ValueError(f"chains {chains} not in the kernel's {FMA_CHAINS}")
    if iters < 0:
        raise ValueError(f"iters {iters} < 0")
    y = _out_like(x, out)
    err = _build.kernels().ppsim_fma_chain(
        x.data_ptr(), y.data_ptr(), x.numel(), int(iters), int(chains), x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check_launch(err, "fma_chain kernel")
    fma_chain_cuda.launches += 1
    return y


fma_chain_cuda.launches = 0


def stream_add_plain(x, out=None):
    """``x + 1`` in plain torch."""
    if out is None:
        return x + 1.0
    return torch.add(x, 1.0, out=_out_like(x, out))


def stream_add_cuda(x, out=None):
    """``x + 1``: CUDA tensors launch ``stream_add``
    (``stream_add_cuda.launches`` counts the launches; both pointers must be
    16-byte aligned, as every fresh allocation is); CPU tensors run
    :func:`stream_add_plain`."""
    if x.device.type == "cpu":
        return stream_add_plain(x, out)
    _check_input(x)
    y = _out_like(x, out)
    if (x.data_ptr() | y.data_ptr()) % 16:
        raise ValueError("stream_add takes 16-byte aligned tensors")
    err = _build.kernels().ppsim_stream_add(
        x.data_ptr(), y.data_ptr(), x.numel(), x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check_launch(err, "stream_add kernel")
    stream_add_cuda.launches += 1
    return y


stream_add_cuda.launches = 0
