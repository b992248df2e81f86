"""Readings that set the limits of `correct`, on the card at a cell's own
size: the program's compared numbers over many seeds, the control's (the
reference in fp8 in the program's place) and each planted fault's, all in
one process. Not part of a benchmark run.

    python3 -m hosbench.calibrate --workload composed.p8 --seeds 1-12 \\
        --control-seeds 1-3 --faults half:1-3 [--look] [--out FILE]

Prints one JSON line per reading: {"what", "seed", the numbers, the
loss terms of the first step on both sides, "other_share" (the reference's
share of each parameter's first gradient that the flow and cycle terms
carry, a composed cell), "leaves"} with each parameter's [program |g|,
reference |g|, 1 - cos, program |change|, reference |change|]. `--look`
adds the count of the reference's first-step samples whose forward-LBS
weight sum sits at its 1e-4 clamp, and how its flow term spreads over
the samples. `--set key=json` changes one setting
of the cell on both sides (the look ran the program and the reference
with w_flow=0 and w_cycle=0).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import torch

from hosbench import check, harness
from hosbench.run import open_rank, spawn_ranks


def seeds_of(text: str):
    out = []
    for part in text.split(","):
        if "-" in part:
            a, b = part.split("-")
            out += list(range(int(a), int(b) + 1))
        elif part:
            out.append(int(part))
    return out


def leaves(prog: dict, ref: dict) -> dict:
    cos = (check.cos_gaps(prog["grads"], ref["grads"])
           if "grads" in prog else {})
    return {k: [prog["grad_norms"].get(k, 0.0), ref["grad_norms"][k],
                cos.get(k), prog["change_norms"].get(k, 0.0),
                ref["change_norms"][k]] for k in ref["grad_norms"]}


@contextlib.contextmanager
def clamp_counter(stats: list):
    """Counts, at each forward of the reference's human field, the
    samples inside the body (inverse weight sum over 0.005, the cycle
    loss's mask) and those among them whose forward-LBS weight sum is
    under 1e-4 (clamped) or under 1e-3; and reads how the flow term's
    numerator is spread over the samples: the share of its 10 and 1,000
    largest parts, the largest flow error and the smallest projection
    depth among samples of weight over 1e-6."""
    from hosbench.reference import compose as C
    from hosbench.reference import human as H
    inv, fwd, flow, last = (H.inverse_lbs, H.forward_lbs_multi,
                            C.flow_loss, {})

    def inverse_lbs(pts, m_sR, m_T, vol, bmin, bscale):
        out = inv(pts, m_sR, m_T, vol, bmin, bscale)
        last["fg"] = out[1][:, 0].detach()
        return out

    def forward_lbs_multi(pts, sR_fwd, T_fwd, vol, bmin, bscale):
        B = vol.shape[0] - 1
        with torch.no_grad():
            w = H.sample_bones(vol[:B].reshape(B, -1),
                               H.normalize(pts, bmin, bscale),
                               *vol.shape[1:])
            wsum = w.sum(0)
            body = last["fg"] > 0.005
            stats.append({"samples": int(body.numel()),
                          "body": int(body.sum()),
                          "clamped": int((body & (wsum < 1e-4)).sum()),
                          "under_1e-3": int((body & (wsum < 1e-3)).sum())})
        return fwd(pts, sR_fwd, T_fwd, vol, bmin, bscale)

    def flow_loss(ray_grid, to_cam_prev, intr_prev, weights, deform_prev):
        with torch.no_grad():
            hom = torch.cat([deform_prev,
                             torch.ones_like(deform_prev[..., :1])], -1)
            cam = torch.einsum("ji,rsi->rsj", to_cam_prev, hom)[..., :3]
            pix = torch.einsum("ji,rsi->rsj", intr_prev, cam)
            z = pix[..., 2]
            zsafe = torch.where(z.abs() < 1e-6,
                                torch.where(z < 0, -1e-6, 1e-6), z)
            induced = pix[..., :2] / zsafe[..., None] - ray_grid[:, None, :2]
            err = (induced - ray_grid[:, None, 2:4]).abs().sum(-1)
            part = (err * weights * ray_grid[:, None, 4]).reshape(-1)
            top = torch.sort(part, descending=True).values
            total = float(top.sum())
            w = weights * ray_grid[:, None, 4]
            stats[-1].update(
                flow_top10_share=float(top[:10].sum()) / max(total, 1e-30),
                flow_top1000_share=float(top[:1000].sum())
                / max(total, 1e-30),
                flow_err_max=float(err[w > 1e-6].max())
                if bool((w > 1e-6).any()) else 0.0,
                flow_z_min=float(z[w > 1e-6].abs().min())
                if bool((w > 1e-6).any()) else 0.0)
        return flow(ray_grid, to_cam_prev, intr_prev, weights, deform_prev)

    H.inverse_lbs, H.forward_lbs_multi = inverse_lbs, forward_lbs_multi
    C.flow_loss = flow_loss
    try:
        yield
    finally:
        H.inverse_lbs, H.forward_lbs_multi = inv, fwd
        C.flow_loss = flow


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="", help="name:seeds;name:seeds")
    ap.add_argument("--look", action="store_true")
    ap.add_argument("--set", action="append", default=[],
                    help="key=json: a setting of the cell, both sides")
    ap.add_argument("--out", default=None)
    ap.add_argument("--cpu-rehearsal", action="store_true")
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--init", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    small = args.cpu_rehearsal
    cell = harness.Cell(args.workload, small)
    for kv in args.set:
        k, v = kv.split("=", 1)
        cell.s[k] = json.loads(v)
    world, rank, procs = cell.world, args.rank, []
    if world > 1 and rank == 0:
        args.init, procs = spawn_ranks(argv, world, "hosbench.calibrate")
    device = open_rank(rank, world, args.init, small)
    jobs = [("program", s, None, "none") for s in seeds_of(args.seeds)]
    jobs += [("control", s, "fp8", "none")
             for s in seeds_of(args.control_seeds)]
    for spec in filter(None, args.faults.split(";")):
        name, seeds = spec.split(":")
        jobs += [(name, s, None, name) for s in seeds_of(seeds)]
    out = open(args.out, "a") if args.out and rank == 0 else None
    for what, seed, control, fault in jobs:
        t0 = time.perf_counter()
        stats = []
        look = args.look and what == "program" and rank == 0
        with cell.mod.fault(fault), (clamp_counter(stats) if look
                                     else contextlib.nullcontext()):
            res = harness.run(cell, seed, 0.0, False, device, rank, world,
                              control=control)
        if rank != 0:
            continue
        prog = dict(res["ctrl"] if control
                    else res["everyone"][0]["readings"])
        if not control:
            prog["grads"] = res["first_grads"]
        rec = {"what": what, "seed": seed, "set": args.set,
               **{k: res["worst"][k] for k in check.NUMBERS},
               "correct": res["correct"],
               "leaves_image": res["worst"]["leaves_image"],
               "losses": prog["losses"], "ref_losses": res["ref"]["losses"],
               "terms": prog.get("terms"), "ref_terms": res["ref"]["terms"],
               "other_share": res["ref"].get("other_share"),
               "leaves": leaves(prog, res["ref"])}
        if look:
            rec["clamp"] = stats[0] if stats else None
        rec["seconds"] = time.perf_counter() - t0
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    rc = 0
    for p in procs:
        rc = rc or p.wait()
    return rc


if __name__ == "__main__":
    sys.exit(main())
