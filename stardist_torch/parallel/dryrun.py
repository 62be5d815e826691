"""A dry run of the data-parallel training step (the port's counterpart of
``__graft_entry__.py::dryrun_multichip``).

``dryrun_multichip(n_devices)`` runs one full training step (loss,
gradients, their all-reduce, Adam) of a small StarDist 2D model on
``n_devices`` ranks, each on its rows of one seeded batch, and holds it
against one process on the whole batch: the same loss and gradients, the
same Adam update, and the same weights on every rank.
"""
from __future__ import annotations

import numpy as np
import torch

from .launch import run_ranks

CONFIG = dict(n_rays=8, grid=(2, 2), unet_n_depth=2, unet_n_filter_base=8,
              net_conv_after_unet=16, train_patch_size=(32, 32), train_reduce_lr=None)
TOL = {"cpu": 1e-5, "cuda": 1e-4}   # loss relative; gradients of their largest magnitude


def _batch(n):
    """The seeded target batch of the reference's dry run, of ``n`` rows."""
    rng = np.random.RandomState(0)
    R = CONFIG["n_rays"]
    return {"x": rng.uniform(0, 1, (n, 32, 32, 1)).astype(np.float32),
            "prob": rng.uniform(0, 1, (n, 16, 16, 1)).astype(np.float32),
            "dist": rng.uniform(1, 5, (n, 16, 16, R + 1)).astype(np.float32)}


def _step(device, n):
    """One training step of the model on ``device`` (batch of ``n``; this
    rank's rows of it under a process group): the rows it ran, the loss,
    and each parameter's gradient, update and new value, on the CPU."""
    from ..models import Config2D, StarDist2D
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    model = StarDist2D(Config2D(train_batch_size=n, **CONFIG), basedir=None, device=device)
    model.prepare_for_training()
    before = {k: p.detach().clone() for k, p in model.net.named_parameters()}
    batch = model._put_batch(_batch(n), shard=True)
    metrics = model._train_step(batch)
    return {"rows": len(batch["x"]), "loss": float(metrics[0]),
            "grads": {k: p.grad.cpu() for k, p in model.net.named_parameters()},
            "updates": {k: (p.detach() - before[k]).cpu()
                        for k, p in model.net.named_parameters()},
            "params": {k: p.detach().cpu() for k, p in model.net.named_parameters()}}


def _rank(rank, world_size, device):
    if device == "cuda":
        return _step(torch.device("cuda", rank % torch.cuda.device_count()), world_size)
    return _step(torch.device("cpu"), world_size)


def dryrun_multichip(n_devices, device="cuda", timeout=300):
    """One data-parallel training step on ``n_devices`` ranks against one
    process on the whole batch. ``device="cpu"`` spawns gloo ranks on the
    CPU; ``device="cuda"`` puts the ranks on the visible cards round-robin
    (NCCL when each has its own card, else gloo, since ranks may share a
    card) and raises without a card. Returns a summary dict; raises
    ``AssertionError`` where the ranks disagree with the one process."""
    if device not in ("cpu", "cuda"):
        raise ValueError(f"device must be 'cpu' or 'cuda', got {device!r}")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("dryrun_multichip(device='cuda'): no CUDA device")
    backend = ("nccl" if device == "cuda" and n_devices <= torch.cuda.device_count()
               else "gloo")
    ranks = run_ranks(_rank, n_devices, (device,), backend=backend, timeout=timeout)
    if device == "cuda":
        tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        try:
            one = _step(torch.device("cuda", 0), n_devices)
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    else:
        one = _step(torch.device("cpu"), n_devices)

    tol = TOL[device]
    rows = [r["rows"] for r in ranks]
    assert rows == [1] * n_devices, f"rows per rank {rows}"
    grad_err = upd_err = 0.0
    for r in ranks:
        assert abs(r["loss"] - one["loss"]) <= tol * abs(one["loss"]), (r["loss"], one["loss"])
        for k, g in one["grads"].items():
            scale = float(g.abs().max()) or 1.0
            grad_err = max(grad_err, float((r["grads"][k] - g).abs().max()) / scale)
            # where the gradient is not near 0, Adam's first step (lr g / |g|)
            # moves the weight as the one process's step does
            diff = (r["updates"][k] - one["updates"][k])[g.abs() > 1e-2 * scale]
            upd_err = max(upd_err, float(diff.abs().max()) if len(diff) else 0.0)
            assert torch.equal(r["params"][k], ranks[0]["params"][k]), f"{k}: ranks differ"
    assert grad_err <= tol, f"gradients differ by {grad_err:.3g} of their largest magnitude"
    assert upd_err <= 1e-6, f"Adam's updates differ by {upd_err:.3g}"
    return {"ranks": n_devices, "device": device, "backend": backend, "rows_per_rank": rows,
            "loss": ranks[0]["loss"], "loss_one_process": one["loss"],
            "max_grad_err": grad_err, "max_update_err": upd_err}
