"""The state-conditional dynamic human-object field (counterpart of
`hosnerf_tpu/models/human.py::HumanObjectField`): the render path
(is_train=False) and the stage-2 training path (is_train=True, adding the
cycle and previous-frame flow branches through the forward LBS).

Two per-sample pipelines with one selection rule, as in the JAX package:
* dense (`_samples_dense`): every sample through every stage: the inverse
  LBS of `ops/lbs.py::inverse_warp` (gather form, or the inverse-LBS
  kernel in the row order of `pg_impl`, or its dense core), the MLPs as
  fused kernels or as nn.Modules (over `mlp_chunk` slices, recomputed in
  the backward as `remat` says), the forward LBS of `forward_warp_multi`;
* sorted (`_samples_sorted`): the liveness sort of `ops/cuda/lbs.py`
  puts zero-support samples in a contiguous prefix, the inverse-LBS
  kernel writes them as exact zeros, and every fused embed+trunk and
  forward-LBS kernel call skips whole blocks of that prefix; the default
  for points on a CUDA device, unless `sparse` is False.
`lbs_impl` ('auto' | 'gather' | 'xla' | 'pallas' | 'pallas_dense') and
`mlp_impl` ('auto' | 'flax' | 'fused') keep the JAX package's names:
'pallas' / 'pallas_dense' / 'fused' force the hand-written kernels (or
their plain versions for CPU tensors), 'gather' / 'xla' (the one-hot LBS
form) / 'flax' the plain module path.
`sparse`, `pg_impl` and `pg_sort` (the quad core's row order: 'sig', the
signature-sorted domain, or 'morton') stand for the JAX package's
environment variables HOSNERF_SPARSE, HOSNERF_PG_IMPL and HOSNERF_PG_SORT;
the port reads no environment.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from hosnerf_tpu_torch.core import body as body_math
from hosnerf_tpu_torch.core import render
from hosnerf_tpu_torch.models import embedders
from hosnerf_tpu_torch.models.human_components import (
    BodyPoseRefiner, CanonicalMLP, MotionWeightVolumeDecoder, NonRigidMLP)
from hosnerf_tpu_torch.models.layers import (normal_, resolve_compute_dtype,
                                             resolve_device, resolve_remat)
from hosnerf_tpu_torch.models.state import state_rows
from hosnerf_tpu_torch.ops import lbs as lbs_ops
from hosnerf_tpu_torch.ops.cuda import lbs as cuda_lbs
from hosnerf_tpu_torch.ops.cuda import mlp as cuda_mlp
from hosnerf_tpu_torch.parallel import mesh
from hosnerf_tpu_torch.utils import spans


class HumanObjectField(nn.Module):

    def __init__(self, total_bones: int = 26, n_samples: int = 128,
                 num_states: int = 1, state_embedding_size: int = 64,
                 cnl_multires: int = 10, cnl_mlp_depth: int = 8,
                 cnl_mlp_width: int = 256, nr_multires: int = 6,
                 nr_mlp_depth: int = 6, nr_mlp_width: int = 128,
                 nr_skips: Sequence[int] = (4,),
                 nr_condition_code_size: int = 75,
                 nr_kick_in_iter: int = 10_000,
                 nr_full_band_iter: int = 50_000,
                 pose_embedding_size: int = 75, pose_mlp_width: int = 256,
                 pose_mlp_depth: int = 4, pose_kick_in_iter: int = 0,
                 mweight_embedding_size: int = 256,
                 mweight_volume_size: int = 32,
                 ignore_non_rigid_motions: bool = False,
                 lbs_impl: str = "auto", mlp_impl: str = "auto",
                 compute_dtype=None, sparse: bool = True,
                 pg_impl: str = "quad", remat: Union[bool, str] = "all",
                 mlp_chunk: Optional[int] = None, pg_sort: str = "sig", *,
                 seed: int = 0, device=None):
        super().__init__()
        device = resolve_device(device)
        if pg_impl not in cuda_lbs.PG_CORES:
            raise ValueError(f"unknown pg_impl {pg_impl!r}")
        if pg_sort not in cuda_lbs.PG_SORTS:
            raise ValueError(f"unknown pg_sort {pg_sort!r}")
        self.total_bones = total_bones
        self.n_samples = n_samples
        self.cnl_multires = cnl_multires
        self.cnl_mlp_depth = cnl_mlp_depth
        self.nr_multires = nr_multires
        self.nr_mlp_depth = nr_mlp_depth
        self.nr_skips = tuple(nr_skips)
        self.nr_condition_code_size = nr_condition_code_size
        self.nr_kick_in_iter = nr_kick_in_iter
        self.nr_full_band_iter = nr_full_band_iter
        self.pose_embedding_size = pose_embedding_size
        self.pose_kick_in_iter = pose_kick_in_iter
        self.mweight_volume_size = mweight_volume_size
        self.ignore_non_rigid_motions = ignore_non_rigid_motions
        self.lbs_impl = lbs_impl
        self.mlp_impl = mlp_impl
        self.sparse = sparse
        self.pg_impl = pg_impl
        self.pg_sort = pg_sort
        self.remat = resolve_remat(remat)
        self.mlp_chunk = mlp_chunk
        self.compute_dtype = resolve_compute_dtype(compute_dtype)
        cdt = self.compute_dtype
        gen = torch.Generator().manual_seed(seed)

        self.pose_decoder = BodyPoseRefiner(
            pose_embedding_size, total_bones, pose_mlp_width, pose_mlp_depth,
            generator=gen, device=device)
        self.mweight_vol_decoder = MotionWeightVolumeDecoder(
            mweight_embedding_size, mweight_volume_size, total_bones, cdt,
            generator=gen, device=device)
        nr_embed = embedders.fourier_embed_dim(nr_multires, False)
        # the forward-offset MLP serves the training branches only; it is
        # built so that a full stage-2 state_dict loads strictly
        self.non_rigid_mlp = NonRigidMLP(
            nr_embed, nr_condition_code_size, nr_mlp_depth, nr_mlp_width,
            self.nr_skips, cdt, generator=gen, device=device)
        self.non_rigid_forward_mlp = NonRigidMLP(
            nr_embed, nr_condition_code_size, nr_mlp_depth, nr_mlp_width,
            self.nr_skips, cdt, generator=gen, device=device)
        self.cnl_mlp = CanonicalMLP(
            embedders.fourier_embed_dim(cnl_multires) + state_embedding_size,
            cnl_mlp_depth, cnl_mlp_width, (4,), cdt, generator=gen,
            device=device)
        self.human_stateembeds = nn.ParameterList([
            nn.Parameter(normal_(torch.empty(state_embedding_size,
                                             device=device), 1.0, gen))
            for _ in range(num_states)])

    # ------------------------------------------------------------------
    def _refine_pose(self, dst_Rs, dst_Ts, dst_posevec, iter_val):
        """Pose-decoder residuals on all non-root bones, from
        pose_kick_in_iter on. Before it the decoder still runs and its
        output is selected away (the JAX package's `jnp.where`), so its
        parameters get zero gradients, not none, and Adam counts the step
        as optax does."""
        out = self.pose_decoder(dst_posevec)
        new_Rs = torch.cat([dst_Rs[:1], torch.matmul(dst_Rs[1:], out["Rs"])])
        new_Ts = torch.cat([dst_Ts[:1], dst_Ts[1:] + out["Ts"]])
        if iter_val >= self.pose_kick_in_iter:
            return new_Rs, new_Ts
        off = torch.zeros((), dtype=torch.bool, device=dst_Rs.device)
        return torch.where(off, new_Rs, dst_Rs), torch.where(off, new_Ts,
                                                             dst_Ts)

    def _use_fused_mlp(self, pts) -> bool:
        if self.mlp_impl == "flax":
            return False
        if self.mlp_impl == "fused":
            return True
        if self.mlp_impl != "auto":
            raise ValueError(f"unknown mlp_impl {self.mlp_impl!r}")
        return pts.is_cuda and self.nr_skips == (4,)

    def _mlp_prec(self) -> str:
        return "bf16" if self.compute_dtype == torch.bfloat16 else "highest"

    def _sparse_ok(self, pts, motion_weights_vol, embed) -> bool:
        """Sorted path: `sparse`, the fused MLP kernels AND the pair-grid
        inverse-LBS kernel, with one state row for every sample (a
        per-sample state embedding takes the dense path)."""
        return (self.sparse and self._use_fused_mlp(pts) and embed.ndim == 1
                and lbs_ops.resolve_impl(self.lbs_impl, motion_weights_vol,
                                         pts) == "pallas")

    def _chunked(self, fn, *args):
        """fn over `mlp_chunk`-row slices of the sample axis (all of it at
        once when unset): the rows padded with zeros to a chunk multiple,
        the outputs (tensors or dicts of them) joined and stripped."""
        if not self.mlp_chunk:
            return fn(*args)
        n, c = args[0].shape[0], self.mlp_chunk
        pad = (-n) % c
        if pad:
            args = [torch.cat([a, a.new_zeros((pad,) + a.shape[1:])])
                    for a in args]
        outs = [fn(*(a[s:s + c] for a in args)) for s in range(0, n + pad, c)]
        if isinstance(outs[0], dict):
            return {k: torch.cat([o[k] for o in outs])[:n] for k in outs[0]}
        return torch.cat(outs)[:n]

    def _module_mlp(self, module, *args):
        """A per-sample nn.Module MLP through `_chunked`, each chunk's
        activations recomputed in the backward where `remat` covers the
        module ('all': every MLP; 'heavy': the canonical MLP only), as the
        JAX package's nn.remat does. Values, gradients and parameter names
        do not change."""
        remat = self.remat == "all" or (self.remat == "heavy"
                                        and module is self.cnl_mlp)
        if not remat:
            return self._chunked(module, *args)
        return self._chunked(
            lambda *a: checkpoint(module, *a, use_reentrant=False), *args)

    def _fused_params(self, module, depth: int):
        layers = [(module.layer(i).weight, module.layer(i).bias)
                  for i in range(depth)]
        return layers, (module.head().weight, module.head().bias)

    def _nr_apply(self, module, pts, cond, alpha, k0=None):
        """A non-rigid offset MLP (`non_rigid_mlp` or
        `non_rigid_forward_mlp`) on raw points (hann-windowed PE): pts +
        offsets. cond [N, C] per sample (an expanded row is fine)."""
        if self._use_fused_mlp(pts):
            layers, out = self._fused_params(module, self.nr_mlp_depth)
            return pts + cuda_mlp.fused_embed_trunk(
                pts, cond, alpha, layers, out, kind="hannw",
                multires=self.nr_multires, aux_mode="stream",
                aux_first=True, skip_before=self.nr_skips[0],
                skip_source="embed", precision=self._mlp_prec(),
                k0_blocks=k0)
        embed = embedders.hannw_fourier_embed(pts, self.nr_multires, alpha)
        return self._module_mlp(module, embed, pts, cond)["xyz"]

    def _canonical_raw(self, cnl_pts, embed, k0=None):
        """PE + state embedding -> canonical MLP raw rgb + sigma."""
        if self._use_fused_mlp(cnl_pts) and embed.ndim == 1:
            layers, out = self._fused_params(self.cnl_mlp,
                                             self.cnl_mlp_depth)
            return cuda_mlp.fused_embed_trunk(
                cnl_pts, embed, None, layers, out, kind="fourier",
                multires=self.cnl_multires, aux_mode="broadcast",
                aux_first=False, skip_before=5, skip_source="full_input",
                precision=self._mlp_prec(), k0_blocks=k0)
        xyz = embedders.fourier_embed(cnl_pts, self.cnl_multires)
        embed = embed.expand(xyz.shape[0], embed.shape[-1])
        return self._module_mlp(self.cnl_mlp, torch.cat([xyz, embed], dim=-1))

    def _nr_condition(self, posevec, iter_val):
        """The non-rigid condition row [1, C], zero before its kick-in
        iteration."""
        cond = posevec[None, :self.nr_condition_code_size]
        return cond * float(iter_val >= self.nr_kick_in_iter)

    def _prev_transforms(self, batch, iter_val):
        """Previous-frame pose refine, forward motion bases and condition:
        the flow branch's transform set."""
        dst_Rs, dst_Ts = self._refine_pose(
            batch["dst_Rs_prev"], batch["dst_Ts_prev"],
            batch["dst_posevec_prev"][:self.pose_embedding_size], iter_val)
        _, _, p_sR_fwd, p_T_fwd = body_math.motion_bases(
            dst_Rs, dst_Ts, batch["cnl_gtfms"])
        return p_sR_fwd, p_T_fwd, self._nr_condition(
            batch["dst_posevec_prev"], iter_val)

    # ------------------------------------------------------------------
    def _samples_dense(self, batch, si, embed, iter_val, is_train, R, S):
        """Every sample through every stage. Returns (raw [R, S, 4],
        fg_mask [N, 1], training-branch outputs)."""
        pts_flat, cond, alpha = si["pts_flat"], si["cond"], si["alpha"]
        with spans.span("human.inverse_lbs"):
            x_skel, fg_mask = lbs_ops.inverse_warp(
                pts_flat, si["m_sR"], si["m_T"], si["vol"],
                batch["cnl_bbox_min_xyz"], batch["cnl_bbox_scale_xyz"],
                impl=self.lbs_impl, pg_impl=self.pg_impl,
                pg_sort=self.pg_sort)
        with spans.span("human.trunks"):
            if not self.ignore_non_rigid_motions:
                cnl_pts = self._nr_apply(
                    self.non_rigid_mlp, x_skel,
                    cond.expand(x_skel.shape[0], cond.shape[-1]), alpha)
            else:
                cnl_pts = x_skel
            raw = self._canonical_raw(cnl_pts, embed).reshape(R, S, 4)
        outputs: Dict[str, torch.Tensor] = {}
        if is_train:
            # the cycle and flow branches sample the weight volume once at
            # the canonical points and blend both transform sets; one
            # 2N-sample forward non-rigid pass over both deform streams
            with spans.span("human.pose"):
                p_sR_fwd, p_T_fwd, cond_prev = self._prev_transforms(
                    batch, iter_val)
            with spans.span("human.forward_lbs"):
                deform_both, _ = lbs_ops.forward_warp_multi(
                    cnl_pts, torch.stack([si["m_sR_fwd"], p_sR_fwd]),
                    torch.stack([si["m_T_fwd"], p_T_fwd]), si["vol"],
                    batch["cnl_bbox_min_xyz"], batch["cnl_bbox_scale_xyz"],
                    impl=self.lbs_impl)
            n = cnl_pts.shape[0]
            deform_both = deform_both.reshape(2 * n, 3)
            if not self.ignore_non_rigid_motions:
                cond_both = torch.cat([cond.expand(n, cond.shape[-1]),
                                       cond_prev.expand(n, cond.shape[-1])])
                with spans.span("human.trunks"):
                    deform_both = self._nr_apply(self.non_rigid_forward_mlp,
                                                 deform_both, cond_both,
                                                 alpha)
            outputs = {
                "observe_pts": pts_flat,
                "cnl_pts": cnl_pts,
                "deform_pts_final": deform_both[:n],
                "cycle_mask": (fg_mask[:, 0] > 0.005).float(),
                "deform_pts_prev_final": deform_both[n:].reshape(R, S, 3),
            }
        return raw, fg_mask, outputs

    def _samples_sorted(self, batch, si, embed, iter_val, is_train, R, S):
        """Liveness-sorted per-sample pipeline (the CUDA path). Every
        kernel skips the dead prefix in whole blocks (one boundary, the
        MLPs' 1024 rows, for all of them): the inverse-LBS kernels store
        its rows as exact zeros, the MLP and forward-LBS kernels leave them
        unwritten, and those are zeroed on the exact group-aligned
        dead/live boundary before anything reads them. Dead samples are masked out of
        every consumer (compositing, the cycle mask, the flow weights), so
        their skipped values and zero cotangents change nothing."""
        B = self.total_bones
        G = self.mweight_volume_size
        pts_flat, cond, alpha = si["pts_flat"], si["cond"], si["alpha"]
        bmin, bscale = batch["cnl_bbox_min_xyz"], batch["cnl_bbox_scale_xyz"]
        with spans.span("human.sort"):
            s_, o_, rg, tg, vol_qz = cuda_lbs.grid_tables(
                si["m_sR"], si["m_T"], si["vol"], bmin, bscale)
            dom = cuda_lbs.bp_prepare(pts_flat, rg, tg, G, B)
            pts_s = dom.sort_rows(pts_flat.float())
            n_pad = pts_s.shape[0]
            k0 = dom.k0_for(cuda_mlp.MLP_TILE)  # == cuda_lbs.INV_TILE
            spans.count_rows(dom, cuda_mlp.MLP_TILE)
        with spans.span("human.inverse_lbs"):
            acc_s = cuda_lbs.inverse_core_pg_s(pts_s, rg, tg, vol_qz,
                                               precision="bf16",
                                               k0_blocks=k0)
            x_skel_s, wsum_s = cuda_lbs.world_from_grid(acc_s, s_, o_)
            live = dom.live_row_mask()

        def grad_gate(x):
            """Identity on values; dead rows pass no cotangent (the
            kernels leave skipped rows' input gradients unwritten)."""
            return torch.where(live, x, x.detach())

        with spans.span("human.trunks"):
            if not self.ignore_non_rigid_motions:
                cnl_pts_s = self._nr_apply(
                    self.non_rigid_mlp, grad_gate(x_skel_s).contiguous(),
                    cond.expand(n_pad, cond.shape[-1]), alpha, k0=k0)
            else:
                cnl_pts_s = x_skel_s
            cnl_pts_s = grad_gate(cnl_pts_s).contiguous()
            raw_s = self._canonical_raw(cnl_pts_s, embed, k0=k0)
        raw_s = torch.where(live, raw_s, 0.0)
        raw = dom.unsort(raw_s).reshape(R, S, 4)
        fg_mask = dom.unsort(wsum_s)
        outputs: Dict[str, torch.Tensor] = {}
        if is_train:
            with spans.span("human.pose"):
                p_sR_fwd, p_T_fwd, cond_prev = self._prev_transforms(
                    batch, iter_val)
            with spans.span("human.forward_lbs"):
                deform_s, _ = cuda_lbs.forward_lbs_multi(
                    cnl_pts_s, torch.stack([si["m_sR_fwd"], p_sR_fwd]),
                    torch.stack([si["m_T_fwd"], p_T_fwd]), si["vol"], bmin,
                    bscale, k0_blocks=k0 * (cuda_mlp.MLP_TILE
                                            // cuda_lbs.TILE_SH))
            d0, d1 = grad_gate(deform_s[0]), grad_gate(deform_s[1])
            if not self.ignore_non_rigid_motions:
                with spans.span("human.trunks"):
                    d0 = self._nr_apply(
                        self.non_rigid_forward_mlp, d0.contiguous(),
                        cond.expand(n_pad, cond.shape[-1]), alpha, k0=k0)
                    d1 = self._nr_apply(
                        self.non_rigid_forward_mlp, d1.contiguous(),
                        cond_prev.expand(n_pad, cond.shape[-1]), alpha,
                        k0=k0)
            outputs = {
                "observe_pts": pts_flat,
                "cnl_pts": dom.unsort(torch.where(live, cnl_pts_s, 0.0)),
                "deform_pts_final": dom.unsort(torch.where(live, d0, 0.0)),
                "cycle_mask": (fg_mask[:, 0] > 0.005).float(),
                "deform_pts_prev_final": dom.unsort(
                    torch.where(live, d1, 0.0)).reshape(R, S, 3),
            }
        return raw, fg_mask, outputs

    # ------------------------------------------------------------------
    def forward(self, batch: Dict[str, Any], iter_val, state_idx,
                is_train: bool = False, perturb: float = 0.0,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """batch (tensors on one device): rays_o, rays_d [R, 3]; near, far
        [R, 1]; dst_Rs [B, 3, 3], dst_Ts [B, 3], dst_posevec [75],
        cnl_gtfms [B, 4, 4], motion_weights_priors [B+1, G, G, G],
        cnl_bbox_min_xyz, cnl_bbox_scale_xyz [3], bgcolor [3]; when
        is_train also dst_Rs_prev, dst_Ts_prev, dst_posevec_prev.
        iter_val: a number (the render path uses 10**7); state_idx: index
        tensor, 0-d (one state row) or per-sample. is_train adds the cycle
        and flow branches' outputs; with perturb > 0 and a generator the
        samples are jittered within their bins (uniform draws from that
        generator). Differentiable: callers that only render wrap the call
        in torch.no_grad()."""
        R = batch["rays_o"].shape[0]
        S = self.n_samples
        with spans.span("human.pose"):
            si = self.sample_inputs(batch, iter_val)
        if is_train and perturb > 0.0 and generator is not None:
            z = si["z_vals"]
            mids = 0.5 * (z[..., 1:] + z[..., :-1])
            upper = torch.cat([mids, z[..., -1:]], -1)
            lower = torch.cat([z[..., :1], mids], -1)
            u = mesh.rand_rows(z.shape, generator, z.dtype)
            si["z_vals"] = z = lower + (upper - lower) * u.to(z.device)
            si["pts"] = (batch["rays_o"][:, None, :]
                         + batch["rays_d"][:, None, :] * z[..., None])
            si["pts_flat"] = si["pts"].reshape(-1, 3)
        embed = state_rows(self.human_stateembeds, state_idx)

        samples = (self._samples_sorted
                   if self._sparse_ok(si["pts_flat"], si["vol"], embed)
                   else self._samples_dense)
        raw, fg_mask, outputs = samples(batch, si, embed, iter_val,
                                        is_train, R, S)
        pts_mask = fg_mask.reshape(R, S, 1)

        with spans.span("human.render"):
            rgb_map, acc_map, weights, depth_map = render.raw2outputs(
                raw, pts_mask, si["z_vals"], batch["rays_d"],
                batch["bgcolor"])
        outputs.update({
            "rgb": rgb_map,
            "alpha": acc_map,
            "depth": depth_map,
            "weights": weights,
            "human_rgb": torch.sigmoid(raw[..., :3]),
            "human_density": torch.relu(raw[..., 3]),
            "newsmpl_pts": si["pts"],
            "pts_mask": pts_mask[..., 0],
            "z_vals": si["z_vals"],
        })
        return outputs

    def sample_inputs(self, batch: Dict[str, Any],
                      iter_val) -> Dict[str, Any]:
        """What both per-sample pipelines start from: refined-pose motion
        bases (inverse m_sR [B, 3, 3], m_T [B, 3]; forward m_sR_fwd,
        m_T_fwd), the decoded weight volume [B+1, G, G, G], the non-rigid
        condition row [1, C] and anneal alpha, and the samples (z_vals
        [R, S], pts [R, S, 3], pts_flat)."""
        S = self.n_samples
        dst_Rs, dst_Ts = self._refine_pose(
            batch["dst_Rs"], batch["dst_Ts"],
            batch["dst_posevec"][:self.pose_embedding_size], iter_val)
        m_sR, m_T, m_sR_fwd, m_T_fwd = body_math.motion_bases(
            dst_Rs, dst_Ts, batch["cnl_gtfms"])
        vol = self.mweight_vol_decoder(batch["motion_weights_priors"])
        cond = self._nr_condition(batch["dst_posevec"], iter_val)
        alpha = embedders.hann_alpha(iter_val, self.nr_kick_in_iter,
                                     self.nr_full_band_iter,
                                     self.nr_multires)
        t_vals = torch.linspace(0.0, 1.0, S, device=batch["rays_o"].device,
                                dtype=batch["rays_o"].dtype)
        z_vals = (batch["near"] * (1.0 - t_vals)[None, :]
                  + batch["far"] * t_vals[None, :])
        pts = (batch["rays_o"][:, None, :]
               + batch["rays_d"][:, None, :] * z_vals[..., None])
        return dict(m_sR=m_sR, m_T=m_T, m_sR_fwd=m_sR_fwd, m_T_fwd=m_T_fwd,
                    vol=vol, cond=cond, alpha=alpha, z_vals=z_vals, pts=pts,
                    pts_flat=pts.reshape(-1, 3))
