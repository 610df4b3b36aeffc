"""The LSTM over neighbor sequences that the seq aggregator runs.

The cell is TF1's ``BasicLSTMCell``, written out by hand: one fused
kernel [input + hidden, 4*hidden] and bias [4*hidden], gates in the
order i, j, f, o, ``forget_bias`` 1.0 added to f, a zero initial state.
(``torch.nn.LSTM`` orders its gates i, f, g, o, keeps two biases and
masks no lengths.) The output is each sequence's h at step
``length - 1``, as ``dynamic_rnn``'s length masking gives it. Lengths
count the non-zero neighbor rows: the dummy node's zero rows pad a
short neighborhood.

The input projection is hoisted out of the loop: one [n*S, d] x
[d, 4H] product before it, then h x W_h in each of the S steps. This
splits the JAX package's ``dot(concat([x, h]), kernel) + bias`` into two
sums and adds ``forget_bias`` before the recurrent term, which round
differently in the last bits (the tests hold the two to 1e-5). A bf16
row is promoted to f32 before the product, as ``jnp.concatenate`` with
the f32 ``h`` promotes it; state and carry are f32.

Under tensor parallelism a rank holds a block of the input columns and
the kernel's matching input rows, with the recurrent rows whole
(``parallel/tensor.py``): the hoisted product is then a partial sum,
added over the model group (``reduce``) before the bias, and the
lengths count a row as used where any rank's block of it is non-zero.
"""

from __future__ import annotations

import torch

from graphsage_tpu_torch.nn.init import glorot, zeros


def init_lstm(generator: torch.Generator, input_dim: int, hidden_dim: int,
              device="cpu") -> dict:
    """``kernel`` [input + hidden, 4*hidden] glorot and ``bias``
    [4*hidden] zeros, as one BasicLSTMCell."""
    return {
        "kernel": glorot(generator, (input_dim + hidden_dim, 4 * hidden_dim),
                         device),
        "bias": zeros((4 * hidden_dim,), device),
    }


def lstm_last_output(params: dict, seq: torch.Tensor, lengths: torch.Tensor,
                     forget_bias: float = 1.0, reduce=None) -> torch.Tensor:
    """Run the cell over ``seq`` [n, S, d]; return the f32 h [n, hidden]
    at step ``lengths - 1`` (``lengths`` [n] int32 in [1, S]).

    ``forget_bias`` joins the f gates' bias in the hoisted projection, so
    that one sigmoid over all four gates serves i, f and o (and j's is
    unused). The steps run unmasked and each row's h is picked at
    ``length - 1`` at the end: the state there depends on no later step,
    so this equals freezing the state once ``t >= length``, values and
    gradients alike, with no mask in the loop. ``reduce`` sums the input
    projection of a column block over the model group."""
    n, s, d = seq.shape
    kernel, bias = params["kernel"], params["bias"]
    hidden = kernel.shape[1] // 4
    shift = torch.zeros_like(bias)
    shift[2 * hidden:3 * hidden] = forget_bias
    x = seq.reshape(n * s, d).to(kernel.dtype)
    if reduce is None:
        x_proj = torch.addmm(bias + shift, x, kernel[:d])
    else:
        x_proj = reduce(x @ kernel[:d]) + (bias + shift)
    x_proj = x_proj.view(n, s, 4 * hidden)
    w_h = kernel[d:]
    h = torch.zeros((n, hidden), dtype=torch.float32, device=seq.device)
    c = torch.zeros_like(h)
    hs = []
    # unbind and chunk, not slices: their backward joins the pieces'
    # gradients in one op, where each slice's would fill a zero tensor of
    # the whole (for x_proj, [n, S, 4H] at every step) and add into it
    for x_t in x_proj.unbind(1):
        gates = torch.addmm(x_t, h, w_h)
        i, _, f, o = torch.sigmoid(gates).chunk(4, dim=1)
        j = torch.tanh(gates.narrow(1, hidden, hidden))
        c = torch.addcmul(c * f, i, j)
        h = torch.tanh(c) * o
        hs.append(h)
    rows = torch.arange(n, device=seq.device)
    return torch.stack(hs, dim=1)[rows, lengths.long() - 1]


def neighbor_lengths(neigh_vecs: torch.Tensor, shard=None) -> torch.Tensor:
    """[n] int32: the non-zero rows of each [S, d] sequence, at least 1.
    (The max-abs reduction writes no [n, S, d] temporary.) With
    ``shard``, ``neigh_vecs`` is a column block, and a row counts where
    it is non-zero in any rank's block."""
    if shard is not None:
        used = shard.row_max_abs(neigh_vecs) > 0
    else:
        used = torch.linalg.vector_norm(neigh_vecs, ord=float("inf"),
                                        dim=2) > 0
    return used.sum(dim=1).clamp(min=1).to(torch.int32)
