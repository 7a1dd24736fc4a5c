"""The port's heliostat-axis microbatching against direct evaluation and against JAX's.

``artist_tpu_torch.parallel.microbatch`` runs each chunk under a
non-reentrant checkpoint; these tests hold its values and gradients to the
unchunked evaluation (fp32 sums in another order: rtol 1e-6) and to
``artist_tpu.parallel.microbatch`` on the same numpy inputs, and show that
autograd keeps one chunk's intermediates at a time.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from artist_tpu.parallel import microbatch as jax_microbatch
from artist_tpu_torch.parallel import chunked_map, chunked_sum, chunked_sum_and_map

RNG = np.random.default_rng(7)
XS = RNG.standard_normal((12, 3)).astype(np.float32)
W = RNG.standard_normal(3).astype(np.float32)


def _sum_fn(x):
    return {"a": torch.sum(x**2), "b": torch.sum(x, dim=0)}


def _jax_sum_fn(x):
    return {"a": jnp.sum(x**2), "b": jnp.sum(x, axis=0)}


@pytest.mark.parametrize("remat", [True, False])
def test_chunked_sum_matches_direct_and_jax(remat):
    xs = torch.tensor(XS)
    chunked = chunked_sum(_sum_fn, xs, 3, remat=remat)
    direct = _sum_fn(xs)
    theirs = jax_microbatch.chunked_sum(_jax_sum_fn, jnp.asarray(XS), 3)
    for key in ("a", "b"):
        np.testing.assert_allclose(chunked[key].numpy(), direct[key].numpy(), rtol=1e-6)
        np.testing.assert_allclose(chunked[key].numpy(), np.asarray(theirs[key]), rtol=1e-6)


def test_chunked_map_matches_direct_and_jax():
    xs = torch.tensor(XS)
    pair = chunked_map(lambda x: (x * 2.0 + 1.0, {"norm": x.norm(dim=1)}), xs, 4)
    np.testing.assert_array_equal(pair[0].numpy(), XS * 2.0 + 1.0)
    np.testing.assert_allclose(pair[1]["norm"].numpy(), np.linalg.norm(XS, axis=1), rtol=1e-6)
    theirs = jax_microbatch.chunked_map(lambda x: x * 2.0 + 1.0, jnp.asarray(XS), 4)
    np.testing.assert_array_equal(pair[0].numpy(), np.asarray(theirs))


def test_chunked_sum_and_map_matches_direct_and_jax():
    xs = torch.tensor(XS)
    w = torch.tensor(W, requires_grad=True)
    total, mapped = chunked_sum_and_map(lambda x: (torch.sum((x @ w) ** 2), torch.tanh(x @ w)), xs, 4)
    (total + mapped.sum()).backward()
    w_direct = torch.tensor(W, requires_grad=True)
    direct = torch.sum((xs @ w_direct) ** 2) + torch.sum(torch.tanh(xs @ w_direct))
    direct.backward()
    np.testing.assert_allclose(float((total + mapped.sum()).detach()), float(direct.detach()), rtol=1e-6)
    np.testing.assert_allclose(w.grad.numpy(), w_direct.grad.numpy(), rtol=1e-6)

    def jax_loss(w):
        total, mapped = jax_microbatch.chunked_sum_and_map(
            lambda x: (jnp.sum((x @ w) ** 2), jnp.tanh(x @ w)), jnp.asarray(XS), 4
        )
        return total + jnp.sum(mapped)

    value, grad = jax.value_and_grad(jax_loss)(jnp.asarray(W))
    np.testing.assert_allclose(float((total + mapped.sum()).detach()), float(value), rtol=1e-6)
    np.testing.assert_allclose(w.grad.numpy(), np.asarray(grad), rtol=1e-5)


@pytest.mark.parametrize("remat", [True, False])
def test_gradient_accumulation_matches_direct_and_jax(remat):
    """The parameter is closed over, not passed: the checkpoint still carries its gradient."""
    xs = torch.tensor(XS)
    w = torch.tensor(W, requires_grad=True)
    chunked_sum(lambda x: torch.sum(torch.tanh(x @ w) ** 2), xs, 4, remat=remat).backward()
    w_direct = torch.tensor(W, requires_grad=True)
    torch.sum(torch.tanh(xs @ w_direct) ** 2).backward()
    np.testing.assert_allclose(w.grad.numpy(), w_direct.grad.numpy(), rtol=1e-6)
    grad = jax.grad(
        lambda w: jax_microbatch.chunked_sum(lambda x: jnp.sum(jnp.tanh(x @ w) ** 2), jnp.asarray(XS), 4)
    )(jnp.asarray(W))
    np.testing.assert_allclose(w.grad.numpy(), np.asarray(grad), rtol=1e-5)


@pytest.mark.parametrize("fn", [chunked_map, chunked_sum, chunked_sum_and_map])
def test_chunk_divisibility_error(fn):
    with pytest.raises(ValueError, match="not divisible"):
        fn(lambda x: (x.sum(), x), torch.ones(10, 2), 3)


def _saved_bytes(loss_fn) -> int:
    """Bytes of the tensors autograd keeps for the backward of ``loss_fn()``."""
    saved = []

    def pack(x):
        saved.append(x.numel() * x.element_size())
        return x

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
        loss = loss_fn()
    loss.backward()
    return sum(saved)


def test_saved_tensors_under_remat_are_bounded_by_one_chunk():
    """Unchunked, autograd keeps every row's [rows, 256] intermediates; under remat it keeps
    less than one chunk's, and the backward recomputes the chunks one at a time."""
    rows, width, chunk = 64, 256, 8
    xs = torch.tensor(np.random.default_rng(1).standard_normal((rows, 3)).astype(np.float32))
    w = torch.tensor(np.random.default_rng(2).standard_normal((3, width)).astype(np.float32), requires_grad=True)
    calls = []

    def fn(x):
        calls.append((torch.is_grad_enabled(), tuple(x.shape)))
        hidden = torch.tanh(x @ w)  # [chunk, width], saved for tanh's and the product's backward
        return torch.sum(torch.sin(hidden) ** 2)

    unchunked = _saved_bytes(lambda: fn(xs))
    grad_direct = w.grad.clone()
    w.grad = None
    calls.clear()
    chunked = _saved_bytes(lambda: chunked_sum(fn, xs, chunk))
    np.testing.assert_allclose(w.grad.numpy(), grad_direct.numpy(), rtol=1e-5, atol=1e-6)
    one_chunk = chunk * width * 4  # bytes of one chunk's hidden layer
    assert unchunked >= 3 * (rows // chunk) * one_chunk
    assert chunked < one_chunk
    # Eight forwards, then eight recomputes in the backward, each of one chunk.
    assert calls == [(True, (chunk, 3))] * (2 * rows // chunk)
