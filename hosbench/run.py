"""The benchmark of the PyTorch and CUDA port: one run of one cell.

    python3 -m hosbench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Prints one JSON line last on standard output (`correct`, `attempted`,
`failed`, `metrics`, `device`, with `--trace 1` `breakdown`, and last
`checks`: each compared number with its limit, also the last lines on
standard error). Exits non-zero, printing no result, without a CUDA card
or with fewer cards than the cell asks for, or when JAX or the JAX
package is loaded by the window's close. A four-card cell runs one
process per card (this one is rank 0; the others are started here with
`--rank`), joined over NCCL at a free localhost port.

`--cpu-rehearsal` (tests only): tiny widths on the CPU, the port's
plain kernel versions, a gloo group for a multi-rank cell; its line names
the CPU and is no measurement.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--init", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="tests only: tiny widths on the CPU")
    return ap.parse_args(argv)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(argv, world: int, module: str = "hosbench.run"):
    """Start ranks 1 .. world - 1 of `python -m module argv`, joined at a
    free localhost port: (init address, processes)."""
    init = f"tcp://127.0.0.1:{free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, "-m", module, *argv, "--rank", str(r), "--init",
         init], stdout=subprocess.DEVNULL) for r in range(1, world)]
    return init, procs


def open_rank(rank: int, world: int, init: str, small: bool):
    """The port's card settings, this rank's device (the CPU for a
    rehearsal), and the group of ranks when there are several."""
    import torch
    from hosnerf_tpu_torch.utils import card
    card.configure()
    if small:
        device = torch.device("cpu")
    else:
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    if world > 1:
        from hosnerf_tpu_torch.parallel import distributed
        distributed.initialize(init, world, rank, device=str(device))
    return device


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse(argv)
    import torch
    from hosbench import harness

    small = args.cpu_rehearsal
    cell = harness.Cell(args.workload, small)
    world = cell.world
    if not small:
        if not torch.cuda.is_available():
            print("hosbench: no CUDA card", file=sys.stderr)
            return 3
        if torch.cuda.device_count() < world:
            print(f"hosbench: {args.workload} needs {world} cards, "
                  f"{torch.cuda.device_count()} seen", file=sys.stderr)
            return 3
    procs = []
    if world > 1 and args.rank == 0:
        args.init, procs = spawn_ranks(argv, world)
    torch.set_num_threads(2 if small else 4)
    device = open_rank(args.rank, world, args.init, small)
    try:
        res = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                          device, args.rank, world, T_START)
    finally:
        if world > 1:
            import torch.distributed as dist
            if dist.is_initialized():
                dist.destroy_process_group()
    rc = 0
    for p in procs:
        rc = rc or p.wait()
    if args.rank != 0:
        return 0
    if rc:
        print(f"hosbench: a rank exited with {rc}", file=sys.stderr)
        return 4
    if res["found"]:
        print(f"hosbench: loaded by the window's close: {res['found']}",
              file=sys.stderr)
        return 5
    line = harness.result_line(cell, res, bool(args.trace), device, world)
    w = res["worst"]
    print(f"hosbench: worst grad leaf {w['grad_leaf']}, worst change leaf "
          f"{w['change_leaf']} ({w['leaves_moved']} of {w['leaves']} "
          "leaves moved)", file=sys.stderr)
    print("hosbench: numbers " + json.dumps(
        {k: w[k] for k in harness.check.NUMBERS}), file=sys.stderr)
    for k, v in line["checks"].items():
        print(f"hosbench: check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
