"""Frame sampling helpers (reference: model_utils.py).

The JAX package draws its uniforms from `jax.random`, whose stream torch
cannot reproduce. So each sampler takes either a `torch.Generator` or the
uniforms `u` themselves: the tests feed the port the JAX draws and
compare the gathered frames exactly. A generator given as an int seed
draws through the `frame_uniform` operator (kernels/ops.py), a fresh
generator with that seed on every call: the serving export's baked draw,
as the JAX export's PRNGKey(0). Under `torch.export` a sampler without a
seed, a generator or `u` raises, so that no export bakes a per-call
random draw. A `GlobalDraw` in place of the generator draws for a whole
global batch and keeps a block of its rows: the one-device step's draws
for a tensor-parallel rank's rows.
"""

from __future__ import annotations

from typing import Optional

import torch

from yt8m_tpu_torch.data.quantize import dequantize


def ensure_float(features: torch.Tensor, dtype=torch.float32):
    """Dequantize uint8 features; pass floats through (cast to dtype)."""
    if features.dtype == torch.uint8:
        return dequantize(features.to(dtype))
    return features.to(dtype)


def frame_mask(num_frames: torch.Tensor, max_frames: int,
               dtype=torch.float32):
    """[B] frame counts -> [B, F] validity mask."""
    pos = torch.arange(max_frames, device=num_frames.device)[None, :]
    return (pos < num_frames.to(torch.int64)[:, None]).to(dtype)


class GlobalDraw:
    """A generator for one block of rows of a global batch: each draw is
    the global batch's, [rows, n] from `generator`, of which the model's
    rows [start, start + b) are kept."""

    def __init__(self, generator: torch.Generator, start: int, rows: int):
        self.generator, self.start, self.rows = generator, start, rows


def _uniform(shape, like: torch.Tensor, generator, u):
    if isinstance(generator, GlobalDraw):
        full = torch.rand((generator.rows,) + tuple(shape[1:]),
                          generator=generator.generator, device=like.device,
                          dtype=torch.float32)
        return full[generator.start:generator.start + shape[0]]
    if isinstance(generator, int) and not isinstance(generator, bool):
        from yt8m_tpu_torch.kernels import ops

        return ops.frame_uniform(like, shape[1], generator)
    if u is None and torch.compiler.is_exporting():
        raise ValueError("a frame sampler under torch.export needs a seed "
                         "(generator=<int>) or u: torch.export keeps no "
                         "generator, and its draw would change on every "
                         "call")
    if u is not None:
        u = torch.as_tensor(u, dtype=torch.float32, device=like.device)
        if tuple(u.shape) != tuple(shape):
            raise ValueError(f"u has shape {tuple(u.shape)}, want {shape}")
        return u
    return torch.rand(
        shape, generator=generator, device=like.device, dtype=torch.float32
    )


def _gather_frames(model_input: torch.Tensor, idx: torch.Tensor):
    rows = torch.arange(model_input.shape[0], device=idx.device)[:, None]
    return model_input[rows, idx]


def sample_random_frames(
    model_input: torch.Tensor,
    num_frames: torch.Tensor,
    num_samples: int,
    generator: Optional[torch.Generator] = None,
    u: Optional[torch.Tensor] = None,
):
    """Uniform-with-replacement frame sampling.

    Reference: model_utils.py :: SampleRandomFrames —
    index = floor(U[0,1) * num_frames) per (video, sample), in float32
    as the JAX package computes it. `u` [B, num_samples] overrides the
    generator.
    """
    b = model_input.shape[0]
    u = _uniform((b, num_samples), model_input, generator, u)
    nf = torch.clamp(num_frames.to(torch.float32), min=1.0)
    idx = torch.floor(u * nf[:, None]).to(torch.int64)
    return _gather_frames(model_input, idx)


def sample_random_sequence(
    model_input: torch.Tensor,
    num_frames: torch.Tensor,
    num_samples: int,
    generator: Optional[torch.Generator] = None,
    u: Optional[torch.Tensor] = None,
):
    """Contiguous random crop (reference: SampleRandomSequence).

    start = floor(U * (max(num_frames - num_samples, 0) + 1)); indices
    clipped to the valid range so short videos repeat their last frame.
    `u` [B, 1] overrides the generator.
    """
    b = model_input.shape[0]
    u = _uniform((b, 1), model_input, generator, u)
    nf = num_frames.to(torch.float32)
    max_start = (torch.clamp(nf - num_samples, min=0.0) + 1.0)[:, None]
    start = torch.floor(u * max_start).to(torch.int64)
    offsets = torch.arange(num_samples, device=model_input.device)[None, :]
    hi = torch.clamp(num_frames.to(torch.int64) - 1, min=0)[:, None]
    idx = torch.minimum(torch.clamp(start + offsets, min=0), hi)
    return _gather_frames(model_input, idx)


def frame_pooling(frames: torch.Tensor, method: str,
                  mask: Optional[torch.Tensor] = None):
    """Pool [B, F, D] -> [B, D]; `mask` [B, F] restricts to real frames.

    Reference: model_utils.py :: FramePooling (max | average). Masked max
    pooling fills the masked rows with -1e9; masked mean pooling divides
    by max(sum(mask), 1).
    """
    if method == "max":
        if mask is not None:
            neg = torch.full((), -1e9, dtype=frames.dtype,
                             device=frames.device)
            frames = torch.where(mask[:, :, None] > 0, frames, neg)
        return torch.amax(frames, dim=1)
    if method in ("average", "mean"):
        if mask is None:
            return torch.mean(frames, dim=1)
        denom = torch.clamp_min(torch.sum(mask, dim=1, keepdim=True), 1.0)
        return torch.sum(frames * mask[:, :, None], dim=1) / denom
    raise ValueError(f"unknown pooling method {method!r}")


def masked_mean(features: torch.Tensor, num_frames: torch.Tensor):
    """[B, F, D] (uint8 or float) -> [B, D]: the mean of each video's
    first num_frames frames (divided by at least 1)."""
    features = ensure_float(features)
    mask = frame_mask(num_frames, features.shape[1])
    return frame_pooling(features, "average", mask)


def l2_normalize(x: torch.Tensor, dim, eps: float = 1e-6):
    """x / sqrt(max(sum(x^2), eps^2)) over `dim`.

    The guard is on the squared norm, as in the JAX package (and
    tf.nn.l2_normalize), so that an exactly-zero row has a zero, not NaN,
    gradient.
    """
    sum_sq = torch.sum(x * x, dim=dim, keepdim=True)
    return x / torch.sqrt(torch.clamp_min(sum_sq, eps * eps))
