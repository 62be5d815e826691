"""Data-parallel training in stardist_torch on the CPU: two gloo ranks,
each on its rows of the same batch, against one process on the whole batch.

The cases (one spawn of two ranks runs them all, ``_torch_rank_workers.
dp_train``): a batch of 4 (two rows per rank), a multiclass model (host
targets with class maps) and a batch of 3, which two ranks do not divide
(every rank then runs the whole batch, the reference's unsharded
semantics), and dropout (each rank draws its rows of the whole batch's
masks from the same generator). For each: one step's gradients on one fixed batch within 1e-5
of their largest magnitude (the ranks sum their shares in another order
than one process sums the batch), the losses of 3 steps of ``train`` on
the seeded stream within 1e-5 relative, and the same on both ranks. Then
the loss on row slices, with the normalizers summed over the slices as the
all-reduce sums them, against stardist_tpu's loss on the whole batch
(1e-6), and ``dryrun_multichip(2, device="cpu")``."""
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_rank_workers import ReseedingWriter, dp_train, dp_train_tensorboard
from stardist_torch.models import losses as L
from stardist_torch.parallel import dryrun_multichip, run_ranks
from stardist_tpu.models import losses as JL

torch.set_num_threads(2)

CASES = {"batch4": (4, None), "multiclass": (4, 2), "batch3-undivided": (3, None),
         "dropout": (4, None, 0.3)}


def _ranks(rank, world_size):
    return {name: dp_train(*args) for name, args in CASES.items()}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(_ranks, 2, threads=2, timeout=120, tmp_dir=tmp_path_factory.mktemp("dp"))


@pytest.mark.parametrize("case", sorted(CASES))
def test_two_ranks_equal_one_process(ranks, case):
    batch_size = CASES[case][0]
    grads, losses, history, rows = dp_train(*CASES[case])
    assert rows == batch_size
    for rank, r in enumerate(ranks):
        g_r, losses_r, history_r, rows_r = r[case]
        assert rows_r == (batch_size // 2 if batch_size % 2 == 0 else batch_size)
        for k, g in grads.items():
            scale = float(g.abs().max()) or 1.0
            assert float((g_r[k] - g).abs().max()) <= 1e-5 * scale, (rank, k)
        assert len(losses_r) == len(losses) == 3
        np.testing.assert_allclose(losses_r, losses, rtol=1e-5)
        np.testing.assert_allclose(history_r["val_loss"], history["val_loss"], rtol=1e-5)
    assert ranks[0][case][1] == ranks[1][case][1]          # the ranks agree exactly
    assert ranks[0][case][2] == ranks[1][case][2]


def test_every_rank_draws_rank_0s_stream(tmp_path, monkeypatch):
    """Only rank 0 writes, so only rank 0 opens TensorBoard, whose import
    reseeds numpy's global RNG where TensorFlow is installed (a stand-in
    writer does that here, ``ReseedingWriter``): the other rank must still
    draw rank 0's stream (numpy's state is broadcast just before the
    producer starts), so that two ranks train as one process that opens
    TensorBoard does."""
    import types
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard",
                        types.SimpleNamespace(SummaryWriter=ReseedingWriter))
    one = dp_train_tensorboard(0, 1, str(tmp_path / "one"))
    two = run_ranks(dp_train_tensorboard, 2, (str(tmp_path / "two"),), threads=2, timeout=120,
                    tmp_dir=tmp_path)
    assert len(one) == 3 and two[0] == two[1]
    np.testing.assert_allclose(two[0], one, rtol=1e-5)


@pytest.mark.parametrize("kind", ["mae", "mse", "iou"])
def test_loss_on_slices_equals_reference_on_the_batch(kind):
    """The losses and metrics of two row slices, with the whole batch's
    normalizers, sum to stardist_tpu's on the whole batch."""
    rng = np.random.RandomState(3)
    B, H, W, R = 4, 16, 16, 8
    prob = rng.uniform(0, 1, (B, H, W)).astype(np.float32)
    prob[0, :3] = -1                                   # disabled pixels
    prob_pred = rng.uniform(0.01, 0.99, (B, H, W)).astype(np.float32)
    dist = rng.uniform(1, 5, (B, H, W, R)).astype(np.float32)
    mask = rng.uniform(0, 1, (B, H, W, 1)).astype(np.float32)
    dist_pred = rng.uniform(0.5, 5, (B, H, W, R)).astype(np.float32)
    cls = np.eye(3, dtype=np.float32)[rng.randint(0, 3, (B, H, W))]
    cls_pred = rng.dirichlet(np.ones(3), (B, H, W)).astype(np.float32)

    shard = L.Shard(prob_mask_sum=torch.tensor(float((prob >= 0).sum())),
                    dist_mask_mean=torch.tensor(float(mask.mean(dtype=np.float64))), share=0.5)
    cases = [(L.prob_loss, JL.prob_loss, (prob, prob_pred), {}),
             (L.kld_metric, JL.kld_metric, (prob, prob_pred), {}),
             (L.dist_loss, JL.dist_loss, (dist, mask, dist_pred), dict(kind=kind, reg_weight=1e-4)),
             (L.relevant_mae, JL.relevant_mae, (dist, mask, dist_pred), {}),
             (L.relevant_mse, JL.relevant_mse, (dist, mask, dist_pred), {}),
             (L.dist_iou_metric, JL.dist_iou_metric, (dist, mask, dist_pred), {}),
             (L.class_loss, JL.class_loss, (cls, cls_pred, (1.0, 2.0, 0.5)), {})]
    for f, f_ref, args, kw in cases:
        arrays = [a for a in args if isinstance(a, np.ndarray)]
        rest = args[len(arrays):]
        got = sum(float(f(*[torch.from_numpy(a[sl]) for a in arrays], *rest, shard=shard, **kw))
                  for sl in (slice(0, 2), slice(2, 4)))
        want = float(f_ref(*[jnp.asarray(a) for a in arrays], *rest, **kw))
        assert abs(got - want) <= 1e-6 * max(1.0, abs(want)), (f.__name__, got, want)


def test_dryrun_multichip_cpu():
    out = dryrun_multichip(2, device="cpu", timeout=120)
    assert out["rows_per_rank"] == [1, 1] and out["backend"] == "gloo"
    assert out["max_grad_err"] <= 1e-5


def test_dryrun_multichip_refuses_an_unknown_device():
    """No silent switch: an unknown device raises, and so does "cuda" (the
    default) without a card."""
    with pytest.raises(ValueError):
        dryrun_multichip(2, device="tpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dryrun_multichip(2)
