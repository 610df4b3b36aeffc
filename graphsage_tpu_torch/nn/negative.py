"""Unigram^0.75 negative sampling.

The reference draws negatives with TF's fixed_unigram_candidate_sampler:
node ids with probability proportional to degree^0.75.

* i.i.d. draws (GraphSAGE): inverse-CDF sampling. The cumulative table
  is built once on the host; a draw is a uniform, a ``searchsorted`` and
  a clamp. ``negatives_from_uniforms`` maps given uniforms to ids, so
  that the caller may draw them where it likes (the trainer draws them
  on the host, so the card and the CPU pick the same negatives).
* without replacement (node2vec): Gumbel top-k over the log-weights.

Zero-degree nodes (every val/test node in the train adjacency) have no
mass and are never drawn.
"""

from __future__ import annotations

import numpy as np
import torch


def unigram_cdf(degrees: np.ndarray, distortion: float = 0.75) -> np.ndarray:
    """Host-side cumulative table of degree^distortion, float32 [N]."""
    p = np.power(np.asarray(degrees, dtype=np.float64), distortion)
    cdf = np.cumsum(p)
    return (cdf / cdf[-1]).astype(np.float32)


def negatives_from_uniforms(cdf: torch.Tensor, u: torch.Tensor
                            ) -> torch.Tensor:
    """Uniforms in [0, 1) of any shape -> int32 node ids of that shape,
    by the first CDF entry >= u."""
    idx = torch.searchsorted(cdf, u.contiguous(), side="left",
                             out_int32=True)
    return torch.clamp(idx, 0, cdf.shape[0] - 1)


def sample_negatives(generator: torch.Generator | None, cdf: torch.Tensor,
                     num_samples: int) -> torch.Tensor:
    """``num_samples`` i.i.d. draws from the distorted unigram
    distribution; ``generator`` lives on ``cdf``'s device."""
    u = torch.rand(num_samples, generator=generator, device=cdf.device)
    return negatives_from_uniforms(cdf, u)


def unigram_logits(degrees, distortion: float = 0.75) -> torch.Tensor:
    """Unnormalised log-probabilities for Gumbel top-k (-inf at degree
    0)."""
    deg = torch.as_tensor(degrees, dtype=torch.float32)
    return torch.where(deg > 0,
                       distortion * torch.log(torch.clamp(deg, min=1e-20)),
                       torch.full_like(deg, float("-inf")))


def sample_negatives_unique(generator: torch.Generator | None,
                            logits: torch.Tensor,
                            num_samples: int) -> torch.Tensor:
    """``num_samples`` draws without replacement: Gumbel top-k."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    g = -torch.log(-torch.log(torch.clamp(u, min=tiny)))
    return torch.topk(logits + g, num_samples).indices.to(torch.int32)
