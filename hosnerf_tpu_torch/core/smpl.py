"""Numpy SMPL body model: shape blendshapes, pose blendshapes and LBS over
24 joints (counterpart of `hosnerf_tpu/core/smpl.py`).

It serves the preprocessing that writes a capture's mesh_infos.pkl and
canonical_joints.pkl, not training. The SMPL weights
(basicModel_*_lbs_10_207_0_v1.0.0.pkl) are not redistributable and are
supplied by the user; `SMPL.from_pkl` reads the standard SMPL pickle.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Optional, Tuple

import numpy as np

from hosnerf_tpu_torch.core.body import _rvec_to_rmtx_np

SMPL_24_PARENTS = np.array(
    [0, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18,
     19, 20, 21], dtype=np.int32)


class SMPL:
    """verts, joints = smpl(pose [72], beta [10])."""

    def __init__(self, v_template: np.ndarray, shapedirs: np.ndarray,
                 posedirs: np.ndarray, J_regressor: np.ndarray,
                 weights: np.ndarray, parents: Optional[np.ndarray] = None,
                 faces: Optional[np.ndarray] = None):
        self.v_template = np.asarray(v_template, np.float64)    # [V, 3]
        self.shapedirs = np.asarray(shapedirs, np.float64)      # [V, 3, S]
        self.posedirs = np.asarray(posedirs, np.float64)        # [V, 3, 207]
        self.J_regressor = np.asarray(J_regressor, np.float64)  # [24, V]
        self.weights = np.asarray(weights, np.float64)          # [V, 24]
        self.parents = (np.asarray(parents, np.int32)
                        if parents is not None else SMPL_24_PARENTS)
        self.faces = faces

    @classmethod
    def from_pkl(cls, model_path: str, sex: str = "neutral") -> "SMPL":
        """Load a standard SMPL pickle (basicModel...lbs_10_207_0_v1.0.0.pkl
        or a directory containing SMPL_{SEX}.pkl)."""
        if os.path.isdir(model_path):
            model_path = os.path.join(model_path,
                                      f"SMPL_{sex.upper()}.pkl")
        with open(model_path, "rb") as f:
            data = pickle.load(f, encoding="latin1")

        def dense(x):
            return x.toarray() if hasattr(x, "toarray") else np.asarray(x)

        return cls(
            v_template=dense(data["v_template"]),
            shapedirs=dense(data["shapedirs"])[:, :, :10],
            posedirs=dense(data["posedirs"]),
            J_regressor=dense(data["J_regressor"]),
            weights=dense(data["weights"]),
            parents=np.asarray(data["kintree_table"])[0]
            if "kintree_table" in data else None,
            faces=data.get("f"),
        )

    # ------------------------------------------------------------------
    def joints_rest(self, beta: np.ndarray) -> np.ndarray:
        v_shaped = self.v_template + self.shapedirs @ np.asarray(
            beta, np.float64)
        return self.J_regressor @ v_shaped

    def __call__(self, pose: np.ndarray,
                 beta: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """pose [72] axis-angle (24 joints), beta [10] -> (verts [V, 3],
        joints [24, 3])."""
        pose = np.asarray(pose, np.float64).reshape(24, 3)
        beta = np.asarray(beta, np.float64)

        v_shaped = self.v_template + self.shapedirs @ beta
        J = self.J_regressor @ v_shaped  # [24, 3]

        Rs = np.stack([_rvec_to_rmtx_np(pose[i]).astype(np.float64)
                       for i in range(24)])
        # pose blendshapes from the non-root rotations' deviation from I
        pose_feature = (Rs[1:] - np.eye(3)).reshape(-1)  # [207]
        v_posed = v_shaped + self.posedirs @ pose_feature

        # forward kinematics
        G = np.zeros((24, 4, 4))
        G[0, :3, :3] = Rs[0]
        G[0, :3, 3] = J[0]
        G[0, 3, 3] = 1.0
        parents = self.parents
        for i in range(1, 24):
            local = np.eye(4)
            local[:3, :3] = Rs[i]
            local[:3, 3] = J[i] - J[parents[i]]
            G[i] = G[parents[i]] @ local
        joints = G[:, :3, 3].copy()

        # remove the rest-pose joint locations from the global transforms
        G_rel = G.copy()
        G_rel[:, :3, 3] -= np.einsum("kij,kj->ki", G[:, :3, :3], J)

        T = np.einsum("vk,kij->vij", self.weights, G_rel)  # [V, 4, 4]
        verts = (np.einsum("vij,vj->vi", T[:, :3, :3], v_posed)
                 + T[:, :3, 3])
        return verts.astype(np.float32), joints.astype(np.float32)
