"""Rank functions for the stardist_torch tests that spawn a process group
(``stardist_torch.parallel.run_ranks``): the models they share with the
parent test, multi-process big-image prediction and data-parallel
training. Imports torch, numpy and stardist_torch only, so that a rank
starts quickly."""
import json

import numpy as np
import torch

from stardist_torch.models import Config2D, Config3D, StarDist2D, StarDist3D

BIG_2D = dict(axes="YX", block_size=128, min_overlap=40, context=16)
BIG_3D = dict(axes="ZYX", block_size=(16, 64, 64), min_overlap=(4, 24, 24), context=(0, 8, 8),
              prob_thresh=0.8)


def demo_model(kind):
    """``models/examples``'s 2D_demo or 3D_demo on the CPU ("2D", "3D"); with
    "-mc" a class branch (3 classes in 2D, 2 in 3D, the port's seeded
    weights) on the demo's weights."""
    nd = kind[:2]
    M, C = (StarDist2D, Config2D) if nd == "2D" else (StarDist3D, Config3D)
    demo = M(None, f"{nd}_demo", "models/examples", device="cpu")
    if not kind.endswith("-mc"):
        return demo
    cfg = json.load(open(f"models/examples/{nd}_demo/config.json"))
    cfg = {k: v for k, v in cfg.items() if k not in ("n_dim", "n_channel_out")}
    n_classes = 3 if nd == "2D" else 2
    cfg.update(n_classes=n_classes, train_loss_weights=(1, 0.2, 1),
               train_class_weights=(1,) * (n_classes + 1))
    m = M(C(**cfg), basedir=None, device="cpu")
    m.net.load_state_dict(demo.net.state_dict(), strict=False)
    m.thresholds = demo.thresholds
    return m


def multihost_rank(rank, world_size, kind, img, shared):
    """Both stitch modes of predict_instances_big_multihost on this rank:
    the replicated call's labels and objects, the partitioned call's
    objects (its labels go into the memmap ``shared``), and the blocks and
    exchange of each."""
    from stardist_torch.parallel import predict_instances_big_multihost
    model = demo_model(kind)
    kw = BIG_2D if kind.startswith("2D") else BIG_3D
    st_r, st_p = {}, {}
    labels, polys = predict_instances_big_multihost(model, img, stitch="replicated", stats=st_r,
                                                    **kw)
    out = np.memmap(shared, dtype=np.int32, mode="r+", shape=img.shape)
    _, polys_p = predict_instances_big_multihost(model, img, labels_out=out,
                                                 stitch="partitioned", stats=st_p, **kw)
    out.flush()
    del out
    return {"labels": labels, "polys": polys, "polys_partitioned": polys_p,
            "stats": (st_r, st_p)}


def dp_config(**kw):
    return Config2D(n_rays=8, grid=(2, 2), unet_n_depth=1, unet_n_filter_base=8,
                    net_conv_after_unet=16, train_patch_size=(32, 32), train_reduce_lr=None,
                    **kw)


def dp_data(n_classes=None):
    """Seeded training fields (and classes) for the data-parallel tests."""
    from utils import synthetic_nuclei_2d
    X, Y = [], []
    for s in range(3):
        img, lbl = synthetic_nuclei_2d((64, 64), n=10, r_range=(4, 7), seed=s)
        X.append(np.stack([img] * 2, -1) if n_classes else img)
        Y.append(lbl.astype(np.int32))
    if n_classes is None:
        return X, Y, "auto"
    classes = [{int(i): 1 + int(i) % n_classes for i in np.unique(y[y > 0])} for y in Y]
    return X, Y, classes


def dp_train(batch_size, n_classes=None, dropout=0.0, steps=3, device="cpu"):
    """One training step's gradients on one fixed batch, then ``steps``
    steps of ``train`` from the seeded weights: (gradients, the steps'
    losses, the history, rows per step). Under a process group each rank
    runs its rows."""
    kw = dict(n_channel_in=2, n_classes=n_classes) if n_classes else {}
    cfg = dp_config(train_batch_size=batch_size, unet_dropout=dropout, **kw)
    X, Y, classes = dp_data(n_classes)
    np.random.seed(0)
    m = StarDist2D(cfg, basedir=None, device=device)
    m.prepare_for_training()
    from stardist_torch.models.model2d import StarDistData2D, _BatchDictAdapter
    data = StarDistData2D(X, Y, classes=None if n_classes is None else classes,
                          batch_size=batch_size, length=1, n_rays=cfg.n_rays, grid=cfg.grid,
                          patch_size=cfg.train_patch_size, n_classes=n_classes, device=device)
    raw = m._targets_fn is not None and data.supports_raw
    batch = m._put_batch(_BatchDictAdapter(data, raw=raw)[0], shard=True)
    rows = len(batch["x"])
    m._train_step(batch, torch.Generator(device=device).manual_seed(0))
    grads = {k: p.grad.cpu() for k, p in m.net.named_parameters()}

    m = StarDist2D(cfg, basedir=None, device=device)
    hist = m.train(X, Y, validation_data=(X[:1], Y[:1]) + (() if n_classes is None else
                                                            (classes[:1],)),
                   classes=classes, seed=0, epochs=1, steps_per_epoch=steps)
    return grads, hist.steps["loss"], hist.history, rows




class ReseedingWriter:
    """A TensorBoard ``SummaryWriter`` stand-in that reseeds numpy's global
    RNG when it is made, as importing TensorBoard does where TensorFlow is
    installed, and writes nothing."""

    def __init__(self, log_dir=None):
        np.random.seed(1234)

    def __getattr__(self, name):
        return lambda *args, **kw: None


def dp_train_tensorboard(rank, world_size, folder):
    """3 steps of ``train`` in which only rank 0 keeps a model folder, and so
    opens TensorBoard (:class:`ReseedingWriter`): the steps' losses."""
    import sys
    import types
    if rank == 0:
        sys.modules["torch.utils.tensorboard"] = types.SimpleNamespace(
            SummaryWriter=ReseedingWriter)
    X, Y, _ = dp_data()
    m = StarDist2D(dp_config(train_batch_size=4, train_tensorboard=True), name="tb",
                   basedir=folder if rank == 0 else None, device="cpu")
    hist = m.train(X, Y, validation_data=(X[:1], Y[:1]), seed=0, epochs=1, steps_per_epoch=3)
    return hist.steps["loss"]
