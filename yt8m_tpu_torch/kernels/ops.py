"""The serving kernels as custom operators (`torch.library.custom_op`).

The wrappers launch their kernels through ctypes (kernels/_build.py),
which `torch.export` cannot trace. Each wrapper on a serving path is
registered here as an operator of the `yt8m` namespace whose real
implementation is the wrapper itself, with all of its host work (the
plans, kernels/_schedule.py's live schedule read from num_frames, the
tensor maps), and whose fake implementation derives the outputs' shapes
and dtypes from the inputs' alone, so that it traces under a symbolic
batch. The models call these operators, eager and exported alike: each
kernel keeps one wrapper and one launch count. On CPU tensors the
wrappers run their plain versions, as they do when called directly.

`frame_uniform` is the exported program's frame sampling: the uniforms
of a fresh generator seeded with a baked seed on the features' device,
so that an exported call draws the same frames on every call, those of
the eager model called with `torch.Generator(device).manual_seed(seed)`.

Importing this module registers the operators (infer/export.py ::
load_serving imports it before it loads a program).
"""

from __future__ import annotations

from typing import List

import torch
from torch import Tensor

from yt8m_tpu_torch.kernels import attention_pool as _attention
from yt8m_tpu_torch.kernels import dbof as _dbof
from yt8m_tpu_torch.kernels import gru as _gru
from yt8m_tpu_torch.kernels import lstm as _lstm
from yt8m_tpu_torch.kernels import moe_head as _moe
from yt8m_tpu_torch.kernels import netvlad as _netvlad
from yt8m_tpu_torch.kernels import nextvlad as _nextvlad
from yt8m_tpu_torch.kernels import topk as _topk

NAMESPACE = "yt8m"


def _op(name: str):
    return torch.library.custom_op(f"{NAMESPACE}::{name}", mutates_args=())


@_op("dbof_maxpool")
def dbof_maxpool(x: Tensor, w: Tensor, in_scale: Tensor, in_bias: Tensor,
                 act_scale: Tensor, act_bias: Tensor,
                 split: List[Tensor]) -> Tensor:
    """Row 1 (bf16 and f32 routes): kernels/dbof.py ::
    dbof_cluster_maxpool_v2, [B, K] f32. `split` is [W's split copy]
    (kernels/tf32.py :: split_weights, a serving constant of the f32
    route), or []."""
    return _dbof.dbof_cluster_maxpool_v2(x, w, in_scale, in_bias, act_scale,
                                         act_bias,
                                         split[0] if split else None)


@dbof_maxpool.register_fake
def _(x, w, in_scale, in_bias, act_scale, act_bias, split):
    return x.new_empty((x.shape[0], w.shape[1]), dtype=torch.float32)


@_op("dbof_maxpool_int8")
def dbof_maxpool_int8(x: Tensor, w8: Tensor, a_col: Tensor,
                      b_col: Tensor) -> Tensor:
    """Row 5: kernels/dbof.py :: dbof_cluster_maxpool_int8, [B, K] f32."""
    return _dbof.dbof_cluster_maxpool_int8(x, w8, a_col, b_col)


@dbof_maxpool_int8.register_fake
def _(x, w8, a_col, b_col):
    return x.new_empty((x.shape[0], w8.shape[1]), dtype=torch.float32)


@_op("moe_head")
def moe_head(x: Tensor, gate_kernel: Tensor, expert_kernel: Tensor,
             expert_bias: Tensor, num_mixtures: int,
             split: List[Tensor]) -> Tensor:
    """Row 2 (bf16 and f32): kernels/moe_head.py :: moe_head_serving,
    [B, C] f32. `split` is [the gate split, the expert split]
    (kernels/tf32.py :: split_weights, serving constants of the f32
    route), or []."""
    return _moe.moe_head_serving(x, gate_kernel, expert_kernel, expert_bias,
                                 num_mixtures, split or None)


@moe_head.register_fake
def _(x, gate_kernel, expert_kernel, expert_bias, num_mixtures, split):
    c = gate_kernel.shape[1] // (num_mixtures + 1)
    return x.new_empty((x.shape[0], c), dtype=torch.float32)


@_op("topk")
def topk(x: Tensor, k: int) -> tuple[Tensor, Tensor]:
    """Row 3: kernels/topk.py :: serving_topk, (values [B, k] f32,
    indices [B, k] int32)."""
    return _topk.serving_topk(x, k)


@topk.register_fake
def _(x, k):
    b = x.shape[0]
    return (x.new_empty((b, k), dtype=torch.float32),
            x.new_empty((b, k), dtype=torch.int32))


@_op("netvlad")
def netvlad(frames: Tensor, num_frames: Tensor, cluster_w: Tensor,
            act_scale: Tensor, act_bias: Tensor, centers: Tensor,
            split: List[Tensor]) -> Tensor:
    """Row 8 (bf16 and f32): kernels/netvlad.py :: netvlad_aggregate,
    [B, K, D] f32. `split` is [Wc's split copy] (kernels/tf32.py ::
    split_weights, a serving constant of the f32 route), or []."""
    return _netvlad.netvlad_aggregate(frames, num_frames, cluster_w,
                                      act_scale, act_bias, centers,
                                      split[0] if split else None)


@netvlad.register_fake
def _(frames, num_frames, cluster_w, act_scale, act_bias, centers, split):
    return frames.new_empty((frames.shape[0], cluster_w.shape[1],
                             frames.shape[2]), dtype=torch.float32)


@_op("lstm")
def lstm(x_proj: Tensor, num_frames: Tensor, wh: Tensor, bias: Tensor,
         reverse: bool) -> tuple[Tensor, Tensor, Tensor]:
    """Row 10: kernels/lstm.py :: lstm_recurrence, (outputs [F, B, H],
    final_c, final_h [B, H]) f32."""
    out, (c, h) = _lstm.lstm_recurrence(x_proj, num_frames, wh, bias,
                                        reverse)
    return out, c.contiguous(), h.contiguous()


@lstm.register_fake
def _(x_proj, num_frames, wh, bias, reverse):
    f, b, _ = x_proj.shape
    hd = wh.shape[0]
    return (x_proj.new_empty((f, b, hd), dtype=torch.float32),
            x_proj.new_empty((b, hd), dtype=torch.float32),
            x_proj.new_empty((b, hd), dtype=torch.float32))


@_op("gru")
def gru(xg: Tensor, xc: Tensor, num_frames: Tensor, whg: Tensor,
        whc: Tensor, bg: Tensor, bc: Tensor,
        reverse: bool) -> tuple[Tensor, Tensor]:
    """Row 12: kernels/gru.py :: gru_recurrence, (outputs [F, B, H],
    final h [B, H]) f32."""
    out, h = _gru.gru_recurrence(xg, xc, num_frames, whg, whc, bg, bc,
                                 reverse)
    return out, h.contiguous()


@gru.register_fake
def _(xg, xc, num_frames, whg, whc, bg, bc, reverse):
    f, b, hd = xc.shape
    return (xg.new_empty((f, b, hd), dtype=torch.float32),
            xg.new_empty((b, hd), dtype=torch.float32))


@_op("attention_pool")
def attention_pool(frames: Tensor, num_frames: Tensor,
                   query: Tensor) -> Tensor:
    """Row 14 (bf16 and f32): kernels/attention_pool.py ::
    attention_pool, [B, H, D] f32."""
    return _attention.attention_pool(frames, num_frames, query)


@attention_pool.register_fake
def _(frames, num_frames, query):
    return frames.new_empty((frames.shape[0], query.shape[1],
                             frames.shape[2]), dtype=torch.float32)


@_op("nextvlad")
def nextvlad(frames: Tensor, num_frames: Tensor, expand_w: Tensor,
             attn_w: Tensor, attn_b: Tensor, cluster_w: Tensor,
             centers: Tensor, groups: int, dtype: torch.dtype,
             layout: List[Tensor]) -> Tensor:
    """Row 15: kernels/nextvlad.py :: nextvlad_aggregate, [B, K, P] f32.
    `layout` is the kernel's bf16 weights [we, wc, wa] (`kernel_layout`,
    a serving constant), or [] to make them on the call."""
    lay = None
    if layout:
        we, wc, wa = layout
        lay = {"we": we, "wc": wc, "wa": wa,
               "ab": attn_b.to(torch.float32).contiguous(),
               "centers": centers.to(torch.float32).contiguous(),
               "dims": _nextvlad.dims(expand_w.shape[0], expand_w.shape[1],
                                      groups, cluster_w.shape[1] // groups)}
    return _nextvlad.nextvlad_aggregate(frames, num_frames, expand_w, attn_w,
                                        attn_b, cluster_w, centers, groups,
                                        dtype, layout=lay)


@nextvlad.register_fake
def _(frames, num_frames, expand_w, attn_w, attn_b, cluster_w, centers,
      groups, dtype, layout):
    k = cluster_w.shape[1] // groups
    return frames.new_empty((frames.shape[0], k, centers.shape[1]),
                            dtype=torch.float32)


@_op("frame_uniform")
def frame_uniform(like: Tensor, cols: int, seed: int) -> Tensor:
    """Uniforms [B, cols] f32 on like's device from a fresh generator
    seeded with `seed`: the same draw on every call."""
    gen = torch.Generator(device=like.device)
    gen.manual_seed(seed)
    return torch.rand((like.shape[0], cols), generator=gen,
                      device=like.device, dtype=torch.float32)


@frame_uniform.register_fake
def _(like, cols, seed):
    return like.new_empty((like.shape[0], cols), dtype=torch.float32)


SERVING_OPS = {
    "dbof_maxpool": dbof_maxpool, "dbof_maxpool_int8": dbof_maxpool_int8,
    "moe_head": moe_head, "topk": topk, "netvlad": netvlad, "lstm": lstm,
    "gru": gru, "attention_pool": attention_pool, "nextvlad": nextvlad,
    "frame_uniform": frame_uniform,
}
