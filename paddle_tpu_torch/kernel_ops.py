"""The six hand-written kernels as registered torch ops, in the `ptpu`
namespace.

A wrapper that launched its kernel through ctypes on `data_ptr()` cannot
be traced: `torch.export` and `make_fx` hand it fake tensors, which have
no memory. So each kernel is an op of its own:

- its schema is an entry of `SCHEMAS`, the one table both processes read:
  this module defines the ops from it, and the native programs' build
  writes it into a header that `csrc/native/ptpu_ops.cc` registers
  (`native.py`), so the two cannot drift apart;
- its CUDA implementation is the kernel module's launch
  (`ops/flash_attention.py`, `fusion/decode_attention.py`,
  `fusion/recurrent.py`, which call `impl` when imported): the checks,
  the allocations and the ctypes call on the current stream, and the
  count in `kernels.LAUNCHES`;
- its fake implementation (below) gives the shapes and dtypes of the
  plain version's outputs, so a trace records the op as one opaque node.

The ops have no CPU implementation. The wrappers call them for CUDA
tensors only and take the plain version for CPU tensors, as before; an
op called on a CPU tensor raises. Outputs that a call does not want (K1's
lse without `with_lse`, the recurrent kernels' stash without
`with_stash`) come back as empty [0] tensors: a schema has no optional
return.

| op | replaces (JAX package) | kernel |
| --- | --- | --- |
| flash_fwd | ops/pallas_kernels.py:313 `_flash_kernel` (K1) | csrc/flash_attention.cu |
| flash_bwd_dq | ops/pallas_kernels.py:504 `_flash_bwd_dq_kernel` (K2) | csrc/flash_attention.cu |
| flash_bwd_dkv | ops/pallas_kernels.py:531 `_flash_bwd_dkv_kernel` (K3) | csrc/flash_attention.cu |
| decode_attention | fusion/decode_attention.py:96 `_decode_step_kernel` (K4) | csrc/decode_attention.cu |
| lstm_seq | fusion/recurrent.py:203 `_lstm_seq_kernel` (K5) | csrc/recurrent.cu |
| gru_seq | fusion/recurrent.py:203 `_gru_seq_kernel` (K6) | csrc/recurrent.cu |
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

NAMESPACE = "ptpu"

#: op name -> schema (without the namespace); csrc/native/ptpu_ops.cc
#: registers the same strings
SCHEMAS: Dict[str, str] = {
    "flash_fwd": (
        "flash_fwd(Tensor q, Tensor k, Tensor v, Tensor? q_ids, "
        "Tensor? kv_ids, float scale, bool causal, bool with_lse) "
        "-> (Tensor, Tensor)"),
    "flash_bwd_dq": (
        "flash_bwd_dq(Tensor q, Tensor k, Tensor v, Tensor dout, "
        "Tensor lse, Tensor delta, Tensor? q_ids, Tensor? kv_ids, "
        "float scale, bool causal) -> Tensor"),
    "flash_bwd_dkv": (
        "flash_bwd_dkv(Tensor q, Tensor k, Tensor v, Tensor dout, "
        "Tensor lse, Tensor delta, Tensor? q_ids, Tensor? kv_ids, "
        "float scale, bool causal) -> (Tensor, Tensor)"),
    "decode_attention": (
        "decode_attention(Tensor q, Tensor k, Tensor v, Tensor bias, "
        "float scale, Tensor? k_scale, Tensor? v_scale) -> Tensor"),
    "lstm_seq": (
        "lstm_seq(Tensor x, Tensor h0, Tensor c0, Tensor w, Tensor seqlen, "
        "bool reverse, bool with_stash) -> (Tensor, Tensor, Tensor)"),
    "gru_seq": (
        "gru_seq(Tensor x, Tensor h0, Tensor w, Tensor seqlen, "
        "bool reverse, bool with_stash) -> (Tensor, Tensor)"),
}

_LIB = torch.library.Library(NAMESPACE, "DEF")
for _schema in SCHEMAS.values():
    _LIB.define(_schema)


def qualified_schemas() -> Dict[str, str]:
    """name -> the registered schema as the dispatcher prints it
    (`ptpu::name(...) -> ...`)."""
    return {name: str(getattr(torch.ops.ptpu, name).default._schema)
            for name in SCHEMAS}


def impl(name: str, fn: Callable):
    """Register `fn` as the CUDA implementation of `ptpu::name`."""
    _LIB.impl(name, fn, "CUDA")


def require_cuda(name: str, *tensors):
    """Raise unless every tensor is a CUDA tensor (a wrapper launches its
    kernel or raises; the plain version is the caller's choice, for CPU
    tensors only)."""
    if not all(t.is_cuda for t in tensors):
        raise ValueError(f"{name}: every tensor must be on the same CUDA "
                         f"device")


def _none_or_empty(want, x, shape, dtype=None):
    return x.new_empty(shape, dtype=dtype) if want else \
        x.new_empty((0,), dtype=dtype)


# --- fake implementations: the plain versions' output shapes and dtypes ---

def _flash_fwd_fake(q, k, v, q_ids, kv_ids, scale, causal, with_lse):
    b, h, tq, _ = q.shape
    return torch.empty_like(q), _none_or_empty(with_lse, q, (b, h, tq),
                                               torch.float32)


def _flash_bwd_dq_fake(q, k, v, dout, lse, delta, q_ids, kv_ids, scale,
                       causal):
    return torch.empty_like(q)


def _flash_bwd_dkv_fake(q, k, v, dout, lse, delta, q_ids, kv_ids, scale,
                        causal):
    return torch.empty_like(k), torch.empty_like(v)


def _decode_attention_fake(q, k, v, bias, scale, k_scale, v_scale):
    return q.new_empty(q.shape)


def _lstm_seq_fake(x, h0, c0, w, seqlen, reverse, with_stash):
    b, t, _ = x.shape
    hd = w.shape[0]
    hs = x.new_empty((b, t, hd))
    return hs, x.new_empty((b, t, hd)), _none_or_empty(with_stash, x,
                                                       (b, t, 4 * hd))


def _gru_seq_fake(x, h0, w, seqlen, reverse, with_stash):
    b, t, _ = x.shape
    hd = w.shape[0]
    return x.new_empty((b, t, hd)), _none_or_empty(with_stash, x,
                                                   (b, t, 3 * hd))


for _name, _fake in (("flash_fwd", _flash_fwd_fake),
                     ("flash_bwd_dq", _flash_bwd_dq_fake),
                     ("flash_bwd_dkv", _flash_bwd_dkv_fake),
                     ("decode_attention", _decode_attention_fake),
                     ("lstm_seq", _lstm_seq_fake),
                     ("gru_seq", _gru_seq_fake)):
    torch.library.register_fake(f"{NAMESPACE}::{_name}", _fake, lib=_LIB)
