"""Quality-parity runbook: one command from a capture on disk to a
PARITY_RUN.md of the port's metrics beside the reference's (counterpart
of `tools/parity_runbook.py`).

    python -m hosnerf_tpu_torch.tools.parity_runbook --datadir /data \\
        --scene Backpack [--logbase logs/parity] \\
        [--steps1 N --steps2 N --steps3 N] [--ref_results ref.json] \\
        [--lpips_vgg_path vgg.pth] [--device cpu]

It trains stages 1, 2 and 3 through the port's command line
(`python -m hosnerf_tpu_torch.cli.run`, on the card unless `--device cpu`)
at the given budgets (defaults: the reference's full budgets; small
values give a mini-budget sanity run), evaluates after each stage (the
reference's automatic `trainer.test` pass), collects every results.json
and writes PARITY_RUN.md.

`--ref_results` is a JSON of the reference's own results.json numbers
(its test_step on the released checkpoints) keyed by stage; with it the
report shows the difference per metric and a pass/fail against the 0.2 dB
PSNR target (BASELINE.md). Every metric row carries the lpips_backbone
recorded in results.json: a `random` backbone means the LPIPS values are
not metric-grade, and the report says so.

Two repairs of the JAX runbook, whose commands stop at stage 3 on a fresh
capture: `--datadir` reaches stages 2 and 3 (a yaml with `basedir` set to
it is laid over `--cfg`; the JAX runbook left them the yaml's `basedir`),
and stage 3 warm-starts from each stage's `ckpt/best.pt` where the stage
wrote one, else its `ckpt/last.pt` (stage 2 has no validation, so it
never writes a best checkpoint, nor does stage 1 before its first
validation).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

STAGES = (
    # (stage flag, logdir prefix, default steps = reference budget)
    ("scene", "scene", 500_000),
    ("human", "human", 400_000),
    ("hosnerf", "hosnerf", 200_000),
)
PSNR_TARGET_DB = 0.2


def sh(args_list, log_path):
    print("+", " ".join(args_list), flush=True)
    with open(log_path, "a") as f:
        r = subprocess.run(args_list, stdout=f, stderr=subprocess.STDOUT,
                           cwd=REPO)
    if r.returncode != 0:
        sys.exit(f"FAILED ({r.returncode}): {' '.join(args_list)} - see "
                 f"{log_path}")


def find_results(logdir):
    """Load every results.json under logdir, normalized to ONE dict of
    {split: {metric: value}} (+ optional top-level lpips_backbone).
    Scene results are the reference-format LIST [psnr, ssim, lpips,
    {lpips_backbone}?]; human results are already dicts."""
    hits = []
    for root, _, files in os.walk(logdir):
        if "results.json" in files:
            with open(os.path.join(root, "results.json")) as f:
                res = json.load(f)
            hits.append((root, _normalize_results(res)))
    return hits


def _normalize_results(res):
    """-> {split: {metric: float}} + optional top-level lpips_backbone."""
    if not isinstance(res, list):
        return res
    named = {}
    if res and isinstance(res[0], dict) and "psnr" in res[0]:
        # human full eval: [testimgs, allimgs] flat metric dicts
        for tag, entry in zip(("testimgs", "allimgs"), res):
            named[tag] = dict(entry)
            bb = named[tag].pop("lpips_backbone", None)
            if bb is not None:
                named["lpips_backbone"] = bb
    else:
        # scene eval: [psnr_by_split, ssim_by_split, lpips_by_split,
        # {lpips_backbone}?]
        for metric, entry in zip(("psnr", "ssim", "lpips"), res):
            for split, v in (entry or {}).items():
                named.setdefault(split, {})[metric] = v
        for entry in res[3:]:
            if isinstance(entry, dict):
                named.update(entry)
    return named


def report_lines(scene, datadir, seed, logbase, ref):
    """PARITY_RUN.md's lines: one row per (stage, split, metric) of every
    results.json under each stage's logdir, the reference's value and the
    difference where `ref` has it, and the PSNR verdict."""
    lines = ["# PARITY_RUN — ours vs the reference procedure", "",
             f"scene: **{scene}**  datadir: `{datadir}`  seed: {seed}", "",
             "| stage | split | metric | ours | reference | delta | note |",
             "|---|---|---|---|---|---|---|"]
    verdicts = []
    for stage, prefix, _ in STAGES:
        logdir = os.path.join(logbase, f"{prefix}_{scene}")
        for _, res in find_results(logdir):
            backbone = res.get("lpips_backbone", "unknown")
            for split, vals in res.items():
                if not isinstance(vals, dict):
                    continue
                for metric, v in vals.items():
                    if not isinstance(v, (int, float)) or isinstance(
                            v, bool):
                        continue  # provenance strings / is_empty_img
                    rv = ref.get(stage, {}).get(split, {}).get(metric)
                    note = ""
                    if metric == "lpips" and backbone != "vgg16":
                        note = f"NOT metric-grade (backbone={backbone})"
                    delta = "" if rv is None else f"{v - rv:+.3f}"
                    if metric == "psnr" and rv is not None:
                        ok = abs(v - rv) <= PSNR_TARGET_DB
                        verdicts.append(ok)
                        note = (note + " " if note else "") + (
                            "within 0.2 dB" if ok else "**EXCEEDS 0.2 dB**")
                    lines.append(
                        f"| {stage} | {split} | {metric} | {v:.4f} | "
                        f"{'' if rv is None else f'{rv:.4f}'} | {delta} |"
                        f" {note} |")
    lines.append("")
    if verdicts:
        lines.append("**PSNR parity target (<=0.2 dB): "
                     + ("PASS" if all(verdicts) else "FAIL") + "**")
    else:
        lines.append("_No --ref_results given: run the reference's "
                     "test_step on its released checkpoints and pass the "
                     "JSON to get the side-by-side diff._")
    return lines


def stage_ckpt(logbase, prefix, scene):
    """The stage's best.pt where it wrote one, else its last.pt."""
    ckpt = os.path.join(logbase, f"{prefix}_{scene}", "ckpt")
    best = os.path.join(ckpt, "best.pt")
    return best if os.path.exists(best) else os.path.join(ckpt, "last.pt")


def main(argv=None):
    from hosnerf_tpu_torch.utils import card
    ap = argparse.ArgumentParser()
    ap.add_argument("--datadir", required=True,
                    help="capture root in the reference layout")
    ap.add_argument("--scene", required=True, help="scene name (Backpack)")
    ap.add_argument("--logbase", default="logs/parity")
    ap.add_argument("--steps1", type=int, default=None)
    ap.add_argument("--steps2", type=int, default=None)
    ap.add_argument("--steps3", type=int, default=None)
    ap.add_argument("--ginc1", default="configs/Backpack.gin")
    ap.add_argument("--ginc3", default="configs/Backpack_hosnerf.gin")
    ap.add_argument("--cfg", default="configs/default.yaml")
    ap.add_argument("--seed", type=int, default=777,
                    help="the reference's published seed (README.md:90)")
    ap.add_argument("--ref_results", default=None,
                    help="JSON {stage: {split: {psnr, ssim, lpips}}} from "
                         "the reference's test_step")
    ap.add_argument("--lpips_vgg_path", default=None)
    ap.add_argument("--device", default="cuda",
                    help="the command line's --device (default the card)")
    args = ap.parse_args(argv)
    card.configure()

    logbase = os.path.abspath(args.logbase)
    datadir = os.path.abspath(args.datadir)
    os.makedirs(logbase, exist_ok=True)
    log = os.path.join(logbase, "runbook.log")
    steps = {"scene": args.steps1, "human": args.steps2,
             "hosnerf": args.steps3}
    lpips = (["--lpips_vgg_path", args.lpips_vgg_path]
             if args.lpips_vgg_path else [])
    data_yaml = os.path.join(logbase, "runbook_data.yaml")
    with open(data_yaml, "w") as f:
        f.write(f"basedir: '{datadir}'\n")
    cfg = ["--cfg", data_yaml, "--default_cfg", args.cfg]

    common = ["--scene_name", args.scene, "--logbase", logbase,
              "--seed", str(args.seed),
              "--ginb", f'run.datadir = "{datadir}"',
              "--device", args.device]
    stage_args = {
        "scene": lambda: ["--ginc", args.ginc1],
        "human": lambda: cfg,
        "hosnerf": lambda: ["--ginc", args.ginc3] + cfg + [
            "--bkgd_path", stage_ckpt(logbase, "scene", args.scene),
            "--human_path", stage_ckpt(logbase, "human", args.scene)],
    }

    for stage, _, default_steps in STAGES:
        n = steps[stage] or default_steps
        base = [sys.executable, "-m", "hosnerf_tpu_torch.cli.run",
                "--stage", stage] + stage_args[stage]() + common + lpips
        sh(base + ["--run_mode", "train", "--max_steps", str(n)], log)
        sh(base + ["--run_mode", "eval"], log)

    ref = {}
    if args.ref_results:
        with open(args.ref_results) as f:
            ref = json.load(f)
    out = os.path.join(logbase, "PARITY_RUN.md")
    with open(out, "w") as f:
        f.write("\n".join(report_lines(args.scene, args.datadir, args.seed,
                                       logbase, ref)) + "\n")
    print("wrote", out)


if __name__ == "__main__":
    main()
