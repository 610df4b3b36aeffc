"""The port's gather-mean (graphsage_tpu_torch/ops/gather.py) against the
JAX package's Pallas kernel (interpret mode) and reference, and the
wrapper's CPU/CUDA routing."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphsage_tpu.ops.gather import fused_gather_mean as jax_fused
from graphsage_tpu.ops.gather import gather_mean_reference as jax_reference
from graphsage_tpu_torch.ops import build, gather
from graphsage_tpu_torch.ops.gather import (
    fused_gather_mean,
    gather_mean_reference,
)
from tests._torch_common import t


def _inputs(B, S, F, seed, n=40):
    """A [n+1, F] table whose last row is the zero dummy row, and idx
    whose first row hits only the dummy."""
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((n + 1, F)).astype(np.float32)
    feats[n] = 0.0
    idx = rng.integers(0, n + 1, (B, S), dtype=np.int32)
    idx[0] = n
    return feats, idx


@pytest.mark.parametrize("B,S,F", [(8, 5, 16), (13, 25, 32), (1, 1, 8),
                                   (6, 3, 602)])
def test_gather_mean_matches_jax(B, S, F):
    feats, idx = _inputs(B, S, F, seed=B * 100 + S)
    out = fused_gather_mean(t(feats), t(idx)).numpy()
    plain = gather_mean_reference(t(feats), t(idx)).numpy()
    np.testing.assert_array_equal(out, plain)
    np.testing.assert_array_equal(out[0], 0.0)  # the dummy row is zeros
    pallas = jax_fused(jnp.asarray(feats), jnp.asarray(idx), interpret=True)
    ref = jax_reference(jnp.asarray(feats), jnp.asarray(idx))
    np.testing.assert_allclose(out, np.asarray(pallas), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out, np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_gather_mean_bf16_table_matches_jax():
    feats, idx = _inputs(8, 4, 16, seed=3, n=31)
    table = t(feats).to(torch.bfloat16)
    out = fused_gather_mean(table, t(idx))
    assert out.dtype == torch.float32
    pallas = jax_fused(jnp.asarray(feats).astype(jnp.bfloat16),
                       jnp.asarray(idx), interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), rtol=2e-2)


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    feats, idx = _inputs(4, 3, 8, seed=1)
    monkeypatch.setattr(fused_gather_mean, "launches", 0)

    def no_build(name):
        raise AssertionError("a CPU tensor must not reach the kernel")

    monkeypatch.setattr(build, "load", no_build)
    fused_gather_mean(t(feats), t(idx))
    assert fused_gather_mean.launches == 0


def test_other_devices_raise_without_computing(monkeypatch):
    def no_plain(*a):
        raise AssertionError("only CPU tensors take the plain version")

    monkeypatch.setattr(gather, "gather_mean_reference", no_plain)
    feats = torch.zeros((5, 8), device="meta")
    idx = torch.zeros((2, 3), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        gather.fused_gather_mean(feats, idx)


@pytest.mark.parametrize("feats,idx,err", [
    (torch.zeros(5, 8), torch.zeros(2, 3, dtype=torch.int64), TypeError),
    (torch.zeros(5, 8, dtype=torch.float16),
     torch.zeros(2, 3, dtype=torch.int32), TypeError),
    (torch.zeros(8, 5).t(), torch.zeros(2, 3, dtype=torch.int32),
     ValueError),
    (torch.zeros(5, 8), torch.zeros(2, 0, dtype=torch.int32), ValueError),
    (torch.zeros(5, 8), torch.zeros(6, dtype=torch.int32), ValueError),
])
def test_wrapper_rejects_bad_inputs(feats, idx, err):
    with pytest.raises(err):
        fused_gather_mean(feats, idx)


@pytest.mark.parametrize("F,elem,ptr,vec", [
    (602, 4, 0, 2), (640, 4, 0, 4), (3, 4, 0, 1), (602, 2, 0, 2),
    (640, 2, 0, 8), (640, 2, 8, 4), (640, 4, 4, 1),
])
def test_vector_width_divides_rows(F, elem, ptr, vec):
    assert gather._vector_width(F, elem, ptr, 0) == vec


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build("gather_mean")
    assert not any(tmp_path.iterdir())
