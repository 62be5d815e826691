"""ctypes bindings to the native host library (``sd_native.cpp``, a copy of
``stardist_tpu/lib``'s).

The shared library is compiled on first use with ``g++`` (-O3, OpenMP where
the compiler has it) into ``build/stardist_torch/`` beside the package,
named by a hash of the source. It computes star distances, NMS keep flags
and label rasters on the host with the port's semantics: the test oracle of
the port's plain versions and kernels, and a plain-C ABI for non-Python
hosts. No model path of the port calls it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

from ..ops.cuda_build import BUILD_DIR

_LIB = None
_SRC = Path(__file__).parent / "sd_native.cpp"


def _build_lib():
    """The path of the built library, compiled first where it is missing."""
    tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so_path = BUILD_DIR / f"libsd_native_{tag}.so"
    if not so_path.exists():
        tmp = so_path.with_suffix(f".{os.getpid()}.tmp.so")
        cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", str(_SRC), "-o", str(tmp)]
        try:
            subprocess.run(cmd + ["-fopenmp"], check=True, capture_output=True)
        except subprocess.CalledProcessError:
            # a serial build where the compiler has no OpenMP (reference
            # setup.py:13-58 does the same)
            subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, so_path)
    return so_path


def get_lib():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(_build_lib()))
        c_f32p = ctypes.POINTER(ctypes.c_float)
        c_i32p = ctypes.POINTER(ctypes.c_int32)
        c_u8p = ctypes.POINTER(ctypes.c_uint8)
        i, f = ctypes.c_int, ctypes.c_float
        lib.sd2d_star_dist.argtypes = [c_i32p, i, i, i, i, i, c_f32p]
        lib.sd3d_star_dist.argtypes = [c_i32p, i, i, i, c_f32p, i, i, i, i, c_f32p]
        lib.sd2d_nms.argtypes = [c_f32p, c_f32p, i, i, f, i, c_u8p]
        lib.sd3d_nms.argtypes = [c_f32p, c_f32p, c_f32p, c_i32p, i, i, i, f, c_u8p]
        lib.sd2d_polygons_to_label.argtypes = [c_f32p, c_f32p, c_i32p, i, i, i, i, c_i32p, c_i32p]
        lib.sd3d_polyhedra_to_label.argtypes = [
            c_f32p, c_f32p, c_f32p, c_i32p, c_i32p, i, i, i, i, i, i, c_i32p, c_i32p]
        lib.sd3d_dist_to_volume.argtypes = [c_f32p, c_f32p, c_i32p, ctypes.c_int64, i, i, c_f32p]
        lib.sd_version.restype = i
        _LIB = lib
    return _LIB


def _f32(x):
    return np.ascontiguousarray(x, np.float32)


def _i32(x):
    return np.ascontiguousarray(x, np.int32)


def _p(a, typ):
    return a.ctypes.data_as(ctypes.POINTER(typ))


def star_dist2d_native(lbl, n_rays=32, grid=(1, 1)):
    lib = get_lib()
    lbl = _i32(lbl)
    H, W = lbl.shape
    gy, gx = grid
    out = np.empty(((H - 1) // gy + 1, (W - 1) // gx + 1, n_rays), np.float32)
    lib.sd2d_star_dist(_p(lbl, ctypes.c_int32), H, W, n_rays, gy, gx,
                       _p(out, ctypes.c_float))
    return out


def star_dist3d_native(lbl, rays, grid=(1, 1, 1)):
    lib = get_lib()
    lbl = _i32(lbl)
    D, H, W = lbl.shape
    gz, gy, gx = grid
    dirs = _f32(rays.vertices)
    R = len(dirs)
    out = np.empty(((D - 1) // gz + 1, (H - 1) // gy + 1, (W - 1) // gx + 1, R), np.float32)
    lib.sd3d_star_dist(_p(lbl, ctypes.c_int32), D, H, W, _p(dirs, ctypes.c_float),
                       R, gz, gy, gx, _p(out, ctypes.c_float))
    return out


def nms2d_native(dist, points, thresh=0.5, samples=16):
    """Greedy NMS; candidates must be sorted by descending score."""
    lib = get_lib()
    dist = _f32(dist)
    points = _f32(points)
    N, R = dist.shape
    survivors = np.empty(N, np.uint8)
    lib.sd2d_nms(_p(dist, ctypes.c_float), _p(points, ctypes.c_float), N, R,
                 float(thresh), int(samples), _p(survivors, ctypes.c_uint8))
    return survivors.astype(bool)


def nms3d_native(dist, points, rays, thresh=0.5):
    lib = get_lib()
    dist = _f32(dist)
    points = _f32(points)
    verts = _f32(rays.vertices)
    faces = _i32(rays.faces)
    N, R = dist.shape
    F = len(faces)
    survivors = np.empty(N, np.uint8)
    lib.sd3d_nms(_p(dist, ctypes.c_float), _p(points, ctypes.c_float),
                 _p(verts, ctypes.c_float), _p(faces, ctypes.c_int32),
                 N, R, F, float(thresh), _p(survivors, ctypes.c_uint8))
    return survivors.astype(bool)


def polygons_to_label_native(dist, points, shape, order_values, labels=None):
    """Host rasterization of star polygons (winner = max order value).
    With ``labels`` given, the winner order value is mapped to labels[i]+1
    in a final native pass (same contract as ops.rasterize_polygons)."""
    lib = get_lib()
    dist = _f32(dist)
    points = _f32(points)
    order_values = _i32(order_values)
    N, R = dist.shape
    out = np.zeros(shape, np.int32)
    if labels is not None:
        lut = np.zeros(int(order_values.max(initial=0)) + 1, np.int32)
        lut[order_values] = np.asarray(labels, np.int32) + 1
        lut_p = _p(lut, ctypes.c_int32)
    else:
        lut = None
        lut_p = ctypes.cast(None, ctypes.POINTER(ctypes.c_int32))
    lib.sd2d_polygons_to_label(_p(dist, ctypes.c_float), _p(points, ctypes.c_float),
                               _p(order_values, ctypes.c_int32), N, R,
                               shape[0], shape[1], _p(out, ctypes.c_int32), lut_p)
    return out


def polyhedra_to_label_native(dist, points, rays, shape, order_values,
                              return_count=False, labels=None):
    lib = get_lib()
    dist = _f32(dist)
    points = _f32(points)
    verts = _f32(rays.vertices)
    faces = _i32(rays.faces)
    order_values = _i32(order_values)
    N, R = dist.shape
    F = len(faces)
    out = np.zeros(shape, np.int32)
    cnt = np.zeros(shape, np.int32) if return_count else None
    lib.sd3d_polyhedra_to_label(
        _p(dist, ctypes.c_float), _p(points, ctypes.c_float),
        _p(verts, ctypes.c_float), _p(faces, ctypes.c_int32),
        _p(order_values, ctypes.c_int32), N, R, F,
        shape[0], shape[1], shape[2], _p(out, ctypes.c_int32),
        _p(cnt, ctypes.c_int32) if return_count else
        ctypes.cast(None, ctypes.POINTER(ctypes.c_int32)))
    if labels is not None:
        lut = np.zeros(int(order_values.max(initial=0)) + 1, np.int32)
        lut[order_values] = np.asarray(labels, np.int32)
        out = lut[out]
    return (out, cnt) if return_count else out


def dist_to_volume_native(dist, rays):
    """Per-entry polyhedron volume of a dist map (..., R)."""
    lib = get_lib()
    dist = _f32(dist)
    shape = dist.shape[:-1]
    R = dist.shape[-1]
    flat = dist.reshape(-1, R)
    verts = _f32(rays.vertices)
    faces = _i32(rays.faces)
    out = np.empty(len(flat), np.float32)
    lib.sd3d_dist_to_volume(_p(flat, ctypes.c_float), _p(verts, ctypes.c_float),
                            _p(faces, ctypes.c_int32), len(flat), R, len(faces),
                            _p(out, ctypes.c_float))
    return out.reshape(shape)
