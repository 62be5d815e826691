"""stardist_torch's training losses and metrics against the JAX package's
on the same random inputs (with -1 masks on the prob targets): values
within rtol 1e-5 (float32 sums taken in another order), gradients with
respect to the predictions within 1e-5 of their largest magnitude. The
ties of the clips and of min / max, where the gradient is split in half,
are hit on purpose."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stardist_torch.models import losses as T
from stardist_tpu.models import losses as J

torch.set_num_threads(2)
VALUE_RTOL = 1e-5
GRAD_TOL = 1e-5


def _inputs(seed, R=8, shape=(2, 12, 10)):
    rng = np.random.RandomState(seed)
    prob_true = rng.uniform(0, 1, shape).astype(np.float32)
    prob_true[rng.uniform(size=shape) < 0.2] = -1
    prob_true[rng.uniform(size=shape) < 0.1] = 0
    prob_pred = rng.uniform(0, 1, shape).astype(np.float32)
    prob_pred.flat[:4] = [1e-7, np.float32(1 - 1e-7), 0.0, 1.0]       # at and past the clips
    dist_true = rng.uniform(0, 10, shape + (R,)).astype(np.float32)
    dist_pred = rng.normal(3, 4, shape + (R,)).astype(np.float32)
    dist_pred.flat[:6] = dist_true.flat[:6]                          # ties of min / max / abs
    dist_pred.flat[6:9] = 0.0
    dist_mask = np.where(rng.uniform(size=shape + (1,)) < 0.3, 0,
                         rng.uniform(0, 1, shape + (1,))).astype(np.float32)
    return prob_true, prob_pred, dist_true, dist_mask, dist_pred


def _check(fn_t, fn_j, args, wrt):
    """Value and gradient (with respect to argument ``wrt``) of both."""
    ts = [torch.from_numpy(a).requires_grad_(i == wrt) for i, a in enumerate(args)]
    vt = fn_t(*ts)
    vt.backward()
    vj, gj = jax.value_and_grad(fn_j, argnums=wrt)(*[jnp.asarray(a) for a in args])
    assert np.isfinite(float(vt.detach()))
    assert abs(float(vt.detach()) - float(vj)) <= VALUE_RTOL * max(abs(float(vj)), 1e-6)
    gj = np.asarray(gj)
    assert np.abs(ts[wrt].grad.numpy() - gj).max() <= GRAD_TOL * max(np.abs(gj).max(), 1e-6)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", ["prob_loss", "kld_metric"])
def test_prob_losses_equal_jax(name, seed):
    prob_true, prob_pred = _inputs(seed)[:2]
    _check(getattr(T, name), getattr(J, name), (prob_true, prob_pred), 1)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind,reg", [("mae", 1e-4), ("mse", 0.0), ("iou", 1e-4), ("mae", 0.0)])
def test_dist_loss_equals_jax(kind, reg, seed):
    _, _, dist_true, dist_mask, dist_pred = _inputs(seed)
    _check(lambda *a: T.dist_loss(*a, kind=kind, reg_weight=reg),
           lambda *a: J.dist_loss(*a, kind=kind, reg_weight=reg),
           (dist_true, dist_mask, dist_pred), 2)


@pytest.mark.parametrize("name", ["dist_iou_metric", "relevant_mae", "relevant_mse"])
def test_dist_metrics_equal_jax(name):
    _, _, dist_true, dist_mask, dist_pred = _inputs(3)
    _check(getattr(T, name), getattr(J, name), (dist_true, dist_mask, dist_pred), 2)


def test_class_loss_equals_jax():
    rng = np.random.RandomState(5)
    n_classes = 3
    y_true = np.eye(n_classes + 1, dtype=np.float32)[rng.randint(0, n_classes + 1, (2, 9, 7))]
    y_true[rng.uniform(size=(2, 9, 7)) < 0.2] = -1
    logits = rng.normal(size=(2, 9, 7, n_classes + 1)).astype(np.float32)
    y_pred = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    w = (1.0, 2.0, 0.5, 1.0)
    _check(lambda a, b: T.class_loss(a, b, w), lambda a, b: J.class_loss(a, b, w),
           (y_true, y_pred.astype(np.float32)), 1)


def test_unknown_dist_loss_raises():
    x = torch.zeros(1, 2, 2, 3)
    with pytest.raises(ValueError):
        T.dist_loss(x, x[..., :1], x, kind="huber")
