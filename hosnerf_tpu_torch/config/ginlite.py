"""Minimal gin-compatible config parser (a copy of `hosnerf_tpu/config/
ginlite.py`, which imports only the standard library).

Gin files of plain `scope.param = value` bindings (no macros, imports or
scopes beyond one dot), as the original HOSNeRF's stage-1 configs and the
repo's `configs/*.gin` are written; values are Python literals
(`ast.literal_eval`), bare identifiers stay strings.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, Optional


def _parse_value(text: str):
    text = text.strip()
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        # bare identifiers (gin allows unquoted references); keep as string
        return text


def parse_lines(lines: Iterable[str]) -> Dict[str, object]:
    out: Dict[str, object] = {}
    buf = ""
    for raw in lines:
        line = raw.split("#", 1)[0].rstrip()
        if not line.strip():
            continue
        buf += line
        # continue multi-line values (unbalanced brackets)
        if buf.count("(") > buf.count(")") or buf.count("[") > buf.count("]"):
            continue
        if "=" not in buf:
            raise ValueError(f"unparseable gin line: {buf!r}")
        key, val = buf.split("=", 1)
        out[key.strip()] = _parse_value(val)
        buf = ""
    if buf:
        raise ValueError(f"unterminated gin value: {buf!r}")
    return out


# Every binding the framework consumes or the reference's shipped configs
# contain. Real gin raises on unbindable keys; this parser is permissive
# (unknown keys load fine) but WARNS so a typo'd binding
# (`NeRFMLP.netwidht = 512`) can't silently train the default.
KNOWN_KEYS = frozenset({
    "run.dataset_name", "run.datadir", "run.model_name", "run.max_steps",
    "run.log_every_n_steps", "run.grad_max_norm", "run.bkgd_path",
    "run.human_path",
    "LitData.batch_sampler", "LitData.batch_size", "LitData.chunk",
    "LitData.load_radii", "LitData.use_pixel_centers", "LitData.epoch_size",
    "LitData.precrop", "LitData.precrop_steps",
    "LitDataNeRF360V2.near", "LitDataNeRF360V2.far",
    "LitDataNeRF360V2.factor",
    "LitDataHumanObject.near_bkg", "LitDataHumanObject.far_bkg",
    "MipNeRF360.opaque_background", "MipNeRF360.num_prop_samples",
    "MipNeRF360.num_nerf_samples", "MipNeRF360.num_levels",
    "MipNeRF360.compute_dtype",
    "NeRFMLP.netwidth", "NeRFMLP.netdepth",
    "PropMLP.netwidth", "PropMLP.netdepth",
})


def warn_unknown_keys(cfg: Dict[str, object]) -> list:
    """Print a warning per binding that matches no known parameter;
    returns the offending keys (for tests)."""
    import difflib
    unknown = [k for k in cfg if k not in KNOWN_KEYS]
    for k in unknown:
        close = difflib.get_close_matches(k, KNOWN_KEYS, n=1)
        hint = f" (did you mean {close[0]!r}?)" if close else ""
        print(f"[ginlite] WARNING: unknown gin binding {k!r} is accepted "
              f"but ignored{hint}", flush=True)
    return unknown


def parse_config_files_and_bindings(
        files: Iterable[str],
        bindings: Optional[Iterable[str]] = None,
        warn_unknown: bool = True) -> Dict[str, object]:
    """Later files/bindings override earlier ones (gin semantics)."""
    cfg: Dict[str, object] = {}
    for path in files or []:
        with open(path) as f:
            cfg.update(parse_lines(f))
    for b in bindings or []:
        cfg.update(parse_lines([b]))
    if warn_unknown:
        warn_unknown_keys(cfg)
    return cfg


def scoped(cfg: Dict[str, object], scope: str) -> Dict[str, object]:
    """All params bound to `scope` (e.g. 'run') without the prefix."""
    prefix = scope + "."
    return {k[len(prefix):]: v for k, v in cfg.items()
            if k.startswith(prefix)}


def dumps(cfg: Dict[str, object]) -> str:
    """Serialize back to gin text (the reference dumps the merged config to
    <logdir>/config.gin; run.py:106-119)."""
    return "\n".join(f"{k} = {v!r}" for k, v in sorted(cfg.items())) + "\n"
