"""The port's reference optimizers and LR schedule against the JAX
package's optax transforms, step for step on identical gradients.

Both sides apply p + (-lr * u) to float32 parameters for 5 steps at a
different lr each step; parameters and moments within rtol 1e-6 (the
pow of Adam's bias corrections and the order of a fused multiply-add
may differ by an ulp).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepprior_tpu.train import optimizer as jopt

from deepprior_tpu_torch.train import optimizer as topt

SHAPES = [(5, 3), (7,), (2, 2, 3)]
LRS = [1e-4, 1e-4, 1e-3 / 3.0, 9.6e-4, 9.2e-4]


def _run_both(kind):
    rng = np.random.default_rng(0)
    params = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    grads = [[(rng.standard_normal(s) * 10.0 ** rng.integers(-6, 1)).astype(np.float32)
              for s in SHAPES] for _ in LRS]
    tx = jopt.make_optimizer(kind, momentum=0.9)
    jp = [jnp.asarray(p) for p in params]
    jstate = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = topt.make_optimizer(kind, tp, momentum=0.9)
    for lr, g in zip(LRS, grads):
        lr = float(np.float32(lr))
        upd, jstate = tx.update([jnp.asarray(x) for x in g], jstate, jp)
        jp = [p + (-lr * u) for p, u in zip(jp, upd)]
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x)
        opt.param_groups[0]["lr"] = lr
        opt.step()
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-9)
    return jstate, opt, tp


def test_reference_adam_matches_optax():
    jstate, opt, tp = _run_both("adam")
    assert float(opt.param_groups[0]["count"]) == float(jstate.count) == 6.0
    for p, mu, nu in zip(tp, jstate.mu, jstate.nu):
        np.testing.assert_allclose(opt.state[p]["mu"].numpy(), np.asarray(mu), rtol=1e-6)
        np.testing.assert_allclose(opt.state[p]["nu"].numpy(), np.asarray(nu), rtol=1e-6)


def test_reference_adam_gamma_rounds_to_one():
    """gamma = 1 - 1e-8 is 1.0 in float32, so beta1_t stays beta1 at every
    step, as in the reference's float32 run."""
    assert np.float32(1.0 - 1e-8) == np.float32(1.0)
    p = torch.nn.Parameter(torch.zeros(3))
    opt = topt.ReferenceAdam([p], lr=0.1)
    for _ in range(3):
        p.grad = torch.ones(3)
        opt.step()
    # with beta1_t == 0.9 every step, mu after 3 unit gradients is 1 - 0.9^3
    np.testing.assert_allclose(opt.state[p]["mu"].numpy(), 1.0 - 0.9 ** 3, rtol=1e-6)


@pytest.mark.parametrize("kind", ["rmsprop", "sgd_momentum"])
def test_rmsprop_and_momentum_match_optax(kind):
    _run_both(kind)


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="unknown optimizer"):
        topt.make_optimizer("lamb", [torch.nn.Parameter(torch.zeros(1))])


def test_lr_of_ep_matches_jax():
    """Epochs 0-50.  The piecewise parts are equal; the decaying part is
    within two float32 ulps: XLA's CPU exp is not correctly rounded and
    differs from numpy's by an ulp at some epochs, which the product with
    the base rate can widen to two."""
    for base in (0.001, 0.01):
        jsched, tsched = jopt.lr_of_ep(base), topt.lr_of_ep(base)
        for ep in range(51):
            want, got = np.float32(jsched(ep)), tsched(ep)
            assert got.dtype == np.float32
            if ep <= 2:
                assert got == want, ep
            else:
                assert abs(got - want) <= 2 * np.spacing(want), (ep, got, want)
