"""Masked subsampling with fixed shapes (counterpart of the JAX package's
``targets/sampling.py``), with the batch written out.

The JAX functions draw their own uniforms with ``jax.random`` (threefry),
which PyTorch cannot reproduce. Here the uniform draws are an argument:
the training path draws them from an explicit ``torch.Generator`` on the
device (:func:`draw_uniform`), and the parity tests pass in the JAX side's
own draws, so everything downstream of the draws can be held bit for bit.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

Tensor = torch.Tensor
IntOrTensor = Union[int, Tensor]


def draw_uniform(generator: torch.Generator, shape: Sequence[int], device) -> Tensor:
    """float32 uniforms in [0, 1) from ``generator`` (on ``device``)."""
    return torch.rand(tuple(shape), generator=generator, device=device, dtype=torch.float32)


def _subset_by_score(
    member: Tensor, score: Tensor, k: IntOrTensor, k_max: Optional[int]
) -> Tensor:
    """Keep the members whose score reaches the kk-th largest member score,
    kk = min(k, #members[, k_max]) per row. member/score [B, N]; k an int
    or [B] ints."""
    s = torch.where(member, score, score.new_full((), float("-inf")))
    n_member = member.sum(dim=-1)
    kk = torch.minimum(torch.as_tensor(k, device=member.device), n_member)
    if k_max is not None:
        if not isinstance(k, Tensor) and int(k) > k_max:
            raise ValueError(f"k={int(k)} exceeds the static bound k_max={k_max}")
        if k_max <= 0:
            return torch.zeros_like(member)
        kk = torch.clamp(kk, max=k_max)
        top = torch.topk(s, min(int(k_max), member.shape[-1]), dim=-1).values
    else:
        top = torch.sort(s, dim=-1, descending=True).values
    # the kk-th largest score is the cut; kk == 0 keeps nothing
    cut = torch.gather(top, -1, torch.clamp(kk - 1, min=0).expand(member.shape[:-1])[..., None])
    return member & (s >= cut) & (kk > 0).expand(member.shape[:-1])[..., None]


def random_subset_mask(
    u: Tensor, member: Tensor, k: IntOrTensor, k_max: Optional[int] = None
) -> Tensor:
    """A uniform random subset of min(k, member.sum()) members per row:
    ``u`` [B, N] are the uniform draws, ``member`` [B, N] bool, ``k`` an int
    or [B] ints, ``k_max`` a static bound on ``k`` (the cut then comes from a
    top-k instead of a full sort — the same value)."""
    return _subset_by_score(member, u, k, k_max)


def topk_subset_mask(
    member: Tensor, score: Tensor, k: IntOrTensor, k_max: Optional[int] = None
) -> Tensor:
    """The min(k, member.sum()) highest-scoring members per row (biased
    sampling, arXiv:1702.02138); exact ties at the cut all stay."""
    return _subset_by_score(member, score, k, k_max)


def pack_by_priority(u: Tensor, priority: Tensor, n_out: int) -> Tensor:
    """Indices ordered by (priority, random tiebreak ``u``), the first
    ``n_out`` per row: priority [B, N] small non-negative ints, lower first.
    The stable sort of ``priority + u`` (float32) is the JAX argsort."""
    key = priority.float() + u
    return torch.argsort(key, dim=-1, stable=True)[..., :n_out]
