"""The pair-grid prototype on the card: a dynamic-length list of (tile,
bone pair) steps (counterpart of `tools/proto_pairgrid.py`, which tested
the Mosaic features the TPU pair-grid LBS kernel needs).

Step i adds x[tile rows] * (column sums of vol[b] for its NGB bones b) to
its tile's output rows (the first step of a run on one tile sets them,
later steps add) and one to every entry of dvol[b]. The step count is a
device tensor: steps at or beyond it do nothing, without a host sync, and
rows of tiles that no step below it visits stay unwritten.

    python -m hosnerf_tpu_torch.tools.proto_pairgrid

holds the kernel (csrc/proto_pairgrid.cu) against the numpy reference of
the JAX script, full length and cut to 2 steps; `--device cpu` runs the
plain version.
"""

from __future__ import annotations

import argparse
import ctypes

import numpy as np
import torch

from hosnerf_tpu_torch.ops.cuda import _build
from hosnerf_tpu_torch.utils import card

T = 128          # tile rows
G = 32
BPD = 8          # bones incl. dummy
NGB = 2          # bones per pair


def run_plain(n_pairs, ptile, pbone, pts, vol, n_tiles: int):
    """Plain version of `run`, the steps in order. Rows of tiles that no
    step visits are 0 here (the kernel leaves them unwritten)."""
    n = min(int(n_pairs), ptile.shape[0])
    out = torch.zeros(n_tiles * T, vol.shape[-1], device=pts.device)
    dvol = torch.zeros_like(vol, dtype=torch.float32)
    colsum = vol.float().sum(1)                               # [BPD, G]
    x = pts.reshape(-1, 1).float()
    bones = pbone.reshape(-1, NGB)
    for i in range(n):
        t = int(ptile[i])
        first = i == 0 or int(ptile[i - 1]) != t
        rows = slice(t * T, (t + 1) * T)
        contrib = torch.zeros_like(out[rows])
        for j in range(NGB):
            b = int(bones[i, j])
            contrib = contrib + x[rows] * colsum[b][None, :]
            dvol[b] += 1.0
        out[rows] = contrib if first else out[rows] + contrib
    return out, dvol


def run(n_pairs, ptile, pbone, pts, vol, n_tiles: int):
    """(out [n_tiles * T, G], dvol [BPD, G, G]) of the first n_pairs steps.
    n_pairs: int or 1-element int tensor; ptile [cap] and pbone [cap *
    NGB] int32; pts [n_tiles * T, 1] and vol [BPD, G, G] f32. A CPU tensor
    runs `run_plain`; a CUDA tensor the kernel (or raises)."""
    if pts.device.type == "cpu":
        return run_plain(n_pairs, ptile, pbone, pts, vol, n_tiles)
    if not pts.is_cuda:
        raise ValueError(f"unsupported device {pts.device}")
    dev = pts.device
    cap = ptile.shape[0]
    for name, t, dt in (("ptile", ptile, torch.int32),
                        ("pbone", pbone, torch.int32),
                        ("pts", pts, torch.float32),
                        ("vol", vol, torch.float32)):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dt} on {dev}")
    Gv = vol.shape[-1]
    if pbone.numel() != cap * NGB or pts.numel() != n_tiles * T or \
            tuple(vol.shape[1:]) != (Gv, Gv):
        raise ValueError("ptile [cap], pbone [cap * NGB], pts "
                         "[n_tiles * T, 1], vol [BPD, G, G] expected")
    n_t = torch.as_tensor(n_pairs, device=dev).reshape(1).to(torch.int32)
    out = torch.empty(n_tiles * T, Gv, device=dev, dtype=torch.float32)
    dvol = torch.zeros(vol.shape, device=dev, dtype=torch.float32)
    lib = _lib()
    rc = lib.hosnerf_proto_pairgrid(
        n_t.data_ptr(), ptile.data_ptr(), pbone.data_ptr(), pts.data_ptr(),
        vol.data_ptr(), out.data_ptr(), dvol.data_ptr(), cap, T, Gv, NGB,
        torch.cuda.current_stream(dev).cuda_stream)
    run.launches += 1
    _build.check(rc, lib, "proto_pairgrid")
    return out, dvol


run.launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("proto_pairgrid")
    p = ctypes.c_void_p
    i = ctypes.c_int
    _build.declare(lib, "hosnerf_proto_pairgrid",
                   [p, p, p, p, p, p, p, i, i, i, i, p])
    return lib


# the JAX script's case: 4 tiles, 7 steps (tile 0 twice, 1 once, 2 three
# times, 3 once) padded to a capacity of 12
PTILE = np.array([0, 0, 1, 2, 2, 2, 3], np.int32)
PBONE = np.array([[0, 1], [2, 3], [1, 7], [4, 5], [6, 7], [0, 2], [3, 3]],
                 np.int32)
N_TILES, CAP = 4, 12


def case(seed: int = 0):
    """(pts, vol, ptile_p, pbone_p flat) of the JAX script's `main`."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(N_TILES * T, 1)).astype(np.float32)
    vol = rng.normal(size=(BPD, G, G)).astype(np.float32)
    ptile_p = np.concatenate([PTILE, np.zeros(CAP - 7, np.int32)])
    pbone_p = np.concatenate([PBONE, np.zeros((CAP - 7, NGB), np.int32)])
    return pts, vol, ptile_p, pbone_p.reshape(-1)


def reference(pts, vol, n_pairs: int):
    """The JAX script's numpy reference for the first n_pairs steps: (out,
    dvol), every visited tile's rows summed over its steps."""
    ref = np.zeros((N_TILES * T, G), np.float32)
    ref_dvol = np.zeros((BPD, G, G), np.float32)
    for p in range(n_pairs):
        sl = slice(PTILE[p] * T, (PTILE[p] + 1) * T)
        for j in range(NGB):
            b = PBONE[p, j]
            ref[sl] += pts[sl] * vol[b].sum(0)[None, :]
            ref_dvol[b] += 1.0
    return ref, ref_dvol


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    opts = ap.parse_args()
    card.configure()
    dev = torch.device(opts.device)
    pts, vol, ptile_p, pbone_p = case()
    args = [torch.from_numpy(a).to(dev) for a in (ptile_p, pbone_p, pts,
                                                  vol)]
    out, dvol = run(torch.tensor([7], device=dev), *args, N_TILES)
    ref, ref_dvol = reference(pts, vol, 7)
    err = float(np.abs(out.cpu().numpy() - ref).max())
    derr = float(np.abs(dvol.cpu().numpy() - ref_dvol).max())
    print(f"device {dev}: out err {err:.3e}, dvol err {derr:.3e}")
    assert err < 1e-4 and derr < 1e-6, "MISMATCH"
    out2, _ = run(torch.tensor([2], device=dev), *args, N_TILES)
    ref2, _ = reference(pts, vol, 2)
    err2 = float(np.abs(out2[:T].cpu().numpy() - ref2[:T]).max())
    print(f"dynamic-length tile 0 err {err2:.3e}")
    assert err2 < 1e-4
    print("ALL OK")


if __name__ == "__main__":
    main()
