"""The port's LSTM (graphsage_tpu_torch/nn/lstm.py) and seq aggregator
against graphsage_tpu/nn/lstm.py and ``apply_seq`` on the same inputs and
weights: ragged sequences (zero rows padding a short neighborhood, an
all-zero sequence, length 1), f32 and bf16 input.

Tolerance 1e-5: the port hoists the input projection out of the loop,
so x*W_x and h*W_h are summed apart where the JAX cell takes one product
of the concatenated [x, h]; the f32 sums differ in order only. bf16 rows
are promoted to f32 exactly on both sides. Gradients 1e-4 relative,
1e-5 absolute, as the training tests hold them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphsage_tpu.nn import aggregators as jax_aggs
from graphsage_tpu.nn import lstm as jax_lstm
from graphsage_tpu_torch.nn import aggregators
from graphsage_tpu_torch.nn.lstm import (
    init_lstm,
    lstm_last_output,
    neighbor_lengths,
)
from tests._torch_common import port_params, t

TOL = dict(rtol=1e-5, atol=1e-5)
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _ragged(n, S, d, seed):
    """[n, S, d] rows whose tails are zero: sequence 0 is all zeros
    (length clamps to 1), sequence 1 has length 1, sequence 2 length 3,
    the rest random lengths in [1, S]."""
    rng = np.random.default_rng(seed)
    seq = rng.standard_normal((n, S, d)).astype(np.float32)
    lengths = rng.integers(1, S + 1, n)
    lengths[:3] = (0, 1, min(3, S))
    for i, n_used in enumerate(lengths):
        seq[i, n_used:] = 0.0
    return seq


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_neighbor_lengths_matches_jax(dtype):
    tdt, jdt = DTYPES[dtype]
    seq = _ragged(12, 7, 5, seed=1)
    seq[5, 2] = 0.0   # a zero row inside a sequence still counts out
    got = neighbor_lengths(t(seq).to(tdt))
    want = np.asarray(jax_lstm.neighbor_lengths(jnp.asarray(seq, dtype=jdt)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0] == 1 and got[1] == 1 and got[2] == 3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,S,d,H", [(9, 6, 10, 8), (4, 1, 3, 5),
                                     (16, 25, 12, 16)])
def test_lstm_last_output_matches_jax(dtype, n, S, d, H):
    tdt, jdt = DTYPES[dtype]
    seq = _ragged(n, S, d, seed=n + S)
    jp = jax_lstm.init_lstm(jax.random.key(n), d, H)
    jp["bias"] = jnp.asarray(np.random.default_rng(d).standard_normal(
        4 * H).astype(np.float32))
    jseq = jnp.asarray(seq, dtype=jdt)
    lengths = jax_lstm.neighbor_lengths(jseq)
    ref = jax_lstm.lstm_last_output(jp, jseq, lengths)
    got = lstm_last_output(port_params(jp), t(seq).to(tdt), t(lengths))
    assert got.dtype == torch.float32 and got.shape == (n, H)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_lstm_state_freezes_after_length():
    """The state after the last step is the output at length - 1: rows
    past a sequence's length change nothing."""
    rng = np.random.default_rng(3)
    seq = t(rng.standard_normal((5, 6, 4)).astype(np.float32))
    params = init_lstm(torch.Generator().manual_seed(0), 4, 7)
    lengths = torch.tensor([1, 2, 3, 6, 4], dtype=torch.int32)
    out = lstm_last_output(params, seq, lengths)
    for i, n in enumerate(lengths.tolist()):
        alone = lstm_last_output(params, seq[i:i + 1, :n],
                                 torch.tensor([n], dtype=torch.int32))
        torch.testing.assert_close(out[i:i + 1], alone, rtol=1e-6,
                                   atol=1e-7)


def test_init_lstm_matches_jax_shapes():
    want = {k: tuple(v.shape) for k, v in
            jax_lstm.init_lstm(jax.random.key(0), 10, 6).items()}
    params = init_lstm(torch.Generator().manual_seed(0), 10, 6)
    assert {k: tuple(v.shape) for k, v in params.items()} == want
    assert not params["bias"].any()


@pytest.mark.parametrize("concat,bias,model_size,dtype", [
    (True, False, "small", "float32"), (False, True, "small", "float32"),
    (True, False, "big", "float32"), (True, False, "small", "bfloat16"),
])
def test_apply_seq_matches_jax(concat, bias, model_size, dtype):
    tdt, jdt = DTYPES[dtype]
    n, S, d, out_dim = 9, 5, 10, 6
    rng = np.random.default_rng([concat, bias, len(model_size)])
    self_vecs = rng.standard_normal((n, d)).astype(np.float32)
    neigh = _ragged(n, S, d, seed=4)
    jp = jax_aggs.init_aggregator("seq", jax.random.key(2), d, out_dim,
                                  model_size=model_size, bias=bias)
    if bias:
        jp["b"] = jnp.asarray(rng.standard_normal(out_dim).astype(np.float32))
    ref = jax_aggs.apply_aggregator(
        "seq", jp, jnp.asarray(self_vecs, dtype=jdt),
        jnp.asarray(neigh, dtype=jdt), act=jax.nn.relu, concat=concat)
    params = port_params(jp)
    out = aggregators.apply_aggregator(
        "seq", params, t(self_vecs).to(tdt), t(neigh).to(tdt),
        act=torch.relu, concat=concat)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    decayed = aggregators.decay_weights("seq", params)
    assert len(decayed) == len(jax_aggs.decay_weights("seq", jp))
    assert not any(w is params["lstm.kernel"] for w in decayed)


@pytest.mark.parametrize("model_size,bias", [("small", False), ("big", True)])
def test_init_seq_matches_jax(model_size, bias):
    """The key paths and shapes of JAX's init_seq: aggs.{i}.lstm.kernel
    [in + H, 4H], lstm.bias [4H], neigh_w [H, out], self_w [in, out]."""
    jp = jax_aggs.init_aggregator("seq", jax.random.key(0), 10, 6,
                                  model_size=model_size, bias=bias)
    want = {k: tuple(v.shape) for k, v in port_params(jp).items()}
    got = aggregators.init_aggregator("seq", torch.Generator().manual_seed(0),
                                      10, 6, model_size=model_size, bias=bias)
    assert {k: tuple(v.shape) for k, v in got.items()} == want
    H = aggregators.LSTM_HIDDEN[model_size]
    assert want["lstm.kernel"] == (10 + H, 4 * H)


def test_seq_gradients_match_jax():
    """Every parameter's gradient through the hand-written cell against
    jax.grad through the scan."""
    n, S, d, out_dim = 7, 6, 8, 5
    rng = np.random.default_rng(9)
    self_vecs = rng.standard_normal((n, d)).astype(np.float32)
    neigh = _ragged(n, S, d, seed=9)
    jp = jax_aggs.init_aggregator("seq", jax.random.key(4), d, out_dim)

    def jloss(p):
        return jnp.sum(jax_aggs.apply_seq(
            p, jnp.asarray(self_vecs), jnp.asarray(neigh), act=jax.nn.relu,
            concat=True) ** 2)

    want = port_params(jax.grad(jloss)(jp))
    params = port_params(jp)
    for p in params.values():
        p.requires_grad_(True)
    loss = (aggregators.apply_seq(params, t(self_vecs), t(neigh),
                                  act=torch.relu, concat=True) ** 2).sum()
    grads = torch.autograd.grad(loss, list(params.values()))
    for k, g in zip(params, grads):
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_seq_takes_no_dropout():
    p = aggregators.init_aggregator("seq", torch.Generator().manual_seed(0),
                                    4, 3)
    self_vecs, neigh = torch.ones(6, 4), torch.ones(6, 3, 4)
    kw = dict(act=torch.relu, concat=True)
    a = aggregators.apply_seq(p, self_vecs, neigh, dropout_rate=0.5,
                              generator=torch.Generator().manual_seed(1),
                              deterministic=False, **kw)
    assert torch.equal(a, aggregators.apply_seq(p, self_vecs, neigh, **kw))
