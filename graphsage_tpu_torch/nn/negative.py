"""Unigram^0.75 negative sampling.

The reference draws negatives with TF's fixed_unigram_candidate_sampler:
node ids with probability proportional to degree^0.75.

* i.i.d. draws (GraphSAGE): inverse-CDF sampling. The cumulative table
  is built once on the host; a draw is a uniform, a ``searchsorted`` and
  a clamp. ``negatives_from_uniforms`` maps given uniforms to ids, so
  that the caller may draw them where it likes (the trainer draws them
  on the host, so the card and the CPU pick the same negatives).
* without replacement (node2vec): Gumbel top-k over the log-weights,
  the noise drawn on the host (NumPy), in blocks of at most 16 MiB,
  and added to the logits on the device: the add and the top-k are
  exact in float32, so the card and the CPU pick the same negatives for
  one seed.

Zero-degree nodes (every val/test node in the train adjacency) have no
mass and are never drawn.
"""

from __future__ import annotations

import numpy as np
import torch

NOISE_BLOCK_ELEMS = 1 << 22   # host noise per block: 16 MiB of float32


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


def gumbel_noise(rng: np.random.Generator, shape) -> np.ndarray:
    """float32 Gumbel(0, 1) noise of ``shape`` from the host generator
    ``rng``: -log(-log(u)), u uniform in [tiny, 1)."""
    u = rng.random(shape, dtype=np.float32)
    return -np.log(-np.log(np.maximum(u, np.finfo(np.float32).tiny)))


def sample_negatives_unique(rng: np.random.Generator, logits: torch.Tensor,
                            num_samples: int, n_draws: int) -> torch.Tensor:
    """``n_draws`` sets of ``num_samples`` draws without replacement,
    [n_draws, num_samples] int32 on ``logits``' device, largest first:
    Gumbel noise [n_draws, N+1] from the host generator ``rng``, added to
    the logits and cut to the top k there. The noise is drawn and copied
    in blocks of whole rows of at most ``NOISE_BLOCK_ELEMS`` values, so
    its memory does not grow with ``n_draws``; the generator fills its
    draws in sequence, so the ids are those of one [n_draws, N+1] draw."""
    cols = logits.shape[0]
    rows = max(1, NOISE_BLOCK_ELEMS // cols)
    ids = []
    for lo in range(0, n_draws, rows):
        noise = torch.from_numpy(
            gumbel_noise(rng, (min(rows, n_draws - lo), cols)))
        ids.append(torch.topk(logits + noise.to(logits.device), num_samples,
                              dim=-1).indices)
    return torch.cat(ids).to(torch.int32)
