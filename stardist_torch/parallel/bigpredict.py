"""Block-wise prediction of a big image with the block forwards spread over
devices (counterpart of ``stardist_tpu/parallel/bigpredict.py``).

The blocks of ``big.BlockND.cover`` are independent until their ownership
stitch, so a batch of blocks goes through the network at once, each block
on its own entry of ``devices`` (one model replica per entry; an entry may
name a card twice). A reader thread prepares the next batch, at most two
ahead: each block read once, edge blocks padded (reflect) to the uniform
block shape. Each block's outputs are cropped back, its candidates taken
as the reference takes them (``_ind_prob_thresh(prob, prob_thresh, b=2)``,
dist clamped at 1e-3) and then, in block order on the model's device, its
NMS and labels (``_instances_from_prediction``), context crop,
``filter_objects``, ``relabel_sequential`` and write, as in
``StarDistBase.predict_instances_big``.

The JAX package pads a partial last batch to a power-of-two sub-mesh for
XLA's static shapes; here a partial batch runs on its first ``n_real``
devices, with the same result.
"""
from __future__ import annotations

import copy
import queue
import threading
import time

import numpy as np
import torch

from ..big import OBJECT_KEYS
from ..core.axes import axes_dict
from ..matching import relabel_sequential
from ..nms import _ind_prob_thresh


def _devices(model, devices):
    """``devices`` as torch devices (a CUDA device without an index is the
    current card); the default is every visible card when the model is on
    one, else the model's device. CPU and CUDA entries together raise."""
    if devices is None:
        if model.device.type == "cuda":
            return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        return [model.device]
    out = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        out.append(d)
    if not out:
        raise ValueError("devices is empty")
    if len({d.type for d in out}) > 1:
        raise ValueError(f"devices mixes device types: {[str(d) for d in out]}")
    return out


def _replicas(model, devices):
    """One network per entry of ``devices``: the model's own for the first
    entry on the model's device, copies (weights moved there) for the rest."""
    nets, own = [], False
    home = model.device
    if home.type == "cuda" and home.index is None:
        home = torch.device("cuda", torch.cuda.current_device())
    for d in devices:
        if d == home and not own:
            nets.append(model.net)
            own = True
        else:
            nets.append(copy.deepcopy(model.net).to(d))
    return nets


def predict_instances_big_sharded(model, img, axes, block_size, min_overlap, context=None,
                                  labels_out=None, labels_out_dtype=np.int32, devices=None,
                                  prob_thresh=None, nms_thresh=None, show_progress=False, *,
                                  timings=None, **kwargs):
    """Block-wise instance prediction with each batch of blocks forwarded
    over ``devices`` (reference bigpredict.py:27-209). Returns
    ``(labels_out, polys_all)`` as ``StarDistBase.predict_instances_big``
    does; ``img`` must be normalized. ``kwargs`` go to the NMS (what
    ``predict_instances`` takes as ``nms_kwargs``, given flat as in the
    reference: ``samples`` and the scheduling options among them).
    ``show_progress`` shows nothing, as in the reference. ``timings``, if a
    dict, receives the seconds spent waiting for the reader
    (``read_wait``), in the forwards (``forward``) and in the per-block
    candidates, NMS, labels and stitch (``stitch``), and the counts of
    ``blocks`` and ``batches``."""
    devices = _devices(model, devices)
    n_dev = len(devices)

    axes, axes_out, shape_out, full_shape, blocks = model._big_cover(img, axes, block_size,
                                                                      min_overlap, context)
    channel = axes_dict(axes)["C"] if "C" in axes else None

    if np.isscalar(labels_out) and bool(labels_out) is False:
        labels_out = None
    elif labels_out is None:
        labels_out = np.zeros(shape_out, dtype=labels_out_dtype)

    spatial_axes = [i for i in range(img.ndim) if i != channel]
    nets = _replicas(model, devices)

    batch_q = queue.Queue(maxsize=2)
    stop = threading.Event()

    def put(item):
        while not stop.is_set():
            try:
                batch_q.put(item, timeout=0.1)
                return
            except queue.Full:
                pass

    def reader():
        try:
            for i in range(0, len(blocks), n_dev):
                idxs = list(range(i, min(i + n_dev, len(blocks))))
                arrs, pads = [], []
                for bi in idxs:
                    x = np.asarray(blocks[bi].read(img, axes=axes))
                    pad = tuple((0, f - s) for f, s in zip(full_shape, x.shape))
                    if any(p[1] > 0 for p in pad):
                        x = np.pad(x, pad, mode="reflect")
                    if channel is None:
                        x = x[..., np.newaxis]
                    arrs.append(np.ascontiguousarray(x, np.float32))
                    pads.append(pad)
                put((idxs, arrs, pads))
        except Exception as e:                  # raised again by the consumer
            put(e)
            return
        put(None)

    if prob_thresh is None:
        prob_thresh = model.thresholds.prob
    g_spatial = tuple(model.config.grid)
    polys_all = {}
    label_offset = 1
    t_wait = t_fwd = t_stitch = 0.0
    n_batches = 0

    thread = threading.Thread(target=reader, daemon=True)
    thread.start()
    try:
        while True:
            t0 = time.perf_counter()
            item = batch_q.get()
            t_wait += time.perf_counter() - t0
            if item is None:
                break
            if isinstance(item, Exception):
                raise item
            idxs, arrs, pads = item
            n_batches += 1
            t0 = time.perf_counter()
            outs = [net(torch.from_numpy(x).to(d)) for x, net, d in zip(arrs, nets, devices)]
            for d in set(devices):
                if d.type == "cuda":
                    torch.cuda.synchronize(d)
            t1 = time.perf_counter()
            t_fwd += t1 - t0
            for k, bi in enumerate(idxs):
                block = blocks[bi]
                prob, dist, *pc = outs[k]
                crop = tuple(slice(0, (full_shape[i] - pads[k][i][1]) // g)
                             for i, g in zip(spatial_axes, g_spatial))
                prob = prob[crop]
                inds = _ind_prob_thresh(prob, prob_thresh, b=2)
                probi = prob[inds]
                disti = dist[(slice(None),) + crop][:, inds].t().clamp_min(1e-3)
                points = torch.nonzero(inds) * torch.tensor(g_spatial, device=inds.device)
                pci = pc[0][(slice(None),) + crop][:, inds].t() if pc else None
                cand = [t.to(model.device) if t is not None else None
                        for t in (probi, disti, points, pci)]

                block_shape = tuple(s.stop - s.start for s in block.slice_read(axes_out))
                labels, polys = model._instances_from_prediction(
                    block_shape, cand[0], cand[1], cand[2], cand[3], prob_thresh=prob_thresh,
                    nms_thresh=nms_thresh, **kwargs)
                labels = block.crop_context(labels, axes=axes_out)
                labels, polys = block.filter_objects(labels, polys, axes=axes_out)
                labels = relabel_sequential(labels, label_offset)[0]
                if labels_out is not None:
                    block.write(labels_out, labels, axes=axes_out)
                for key, v in polys.items():
                    polys_all.setdefault(key, []).append(v)
                label_offset += len(polys["prob"])
            del outs
            t_stitch += time.perf_counter() - t1
    finally:
        stop.set()
        thread.join()

    if timings is not None:
        timings.update(read_wait=t_wait, forward=t_fwd, stitch=t_stitch, blocks=len(blocks),
                       batches=n_batches)
    polys_all = {k: (np.concatenate(v) if k in OBJECT_KEYS else v[0])
                 for k, v in polys_all.items()}
    return labels_out, polys_all
