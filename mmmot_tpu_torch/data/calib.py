"""KITTI calibration utilities (host side).

The port's copy of ``mmmot_tpu/data/calib.py``.

Rebuild of the reference's frustum-pointnet-style calibration helpers
(reference: point_cloud/kitti_util.py -> Calibration: P2 / R0_rect /
Tr_velo_to_cam projections).  Provides the velodyne->rectified-camera and
rect->image transforms the frustum sampler needs, and composes them into a
single [3, 4] matrix usable by ``ops/frustum.py`` directly on device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np


@dataclass
class Calibration:
    P2: np.ndarray              # [3, 4] camera-2 projection (rect -> image)
    R0: np.ndarray              # [3, 3] rectification rotation
    V2C: np.ndarray             # [3, 4] velodyne -> camera transform

    @staticmethod
    def from_file(path: str) -> "Calibration":
        """Parse a KITTI calib txt (tracking or object layout)."""
        vals: Dict[str, np.ndarray] = {}
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or ":" not in line and " " not in line:
                    continue
                key, _, rest = line.partition(":" if ":" in line else " ")
                try:
                    vals[key.strip()] = np.array(
                        [float(x) for x in rest.split()])
                except ValueError:
                    continue
        P2 = vals["P2"].reshape(3, 4)
        r0_key = "R0_rect" if "R0_rect" in vals else "R_rect"
        R0 = vals[r0_key].reshape(3, 3)
        v2c_key = ("Tr_velo_to_cam" if "Tr_velo_to_cam" in vals
                   else "Tr_velo_cam")
        V2C = vals[v2c_key].reshape(3, 4)
        return Calibration(P2=P2, R0=R0, V2C=V2C)

    def velo_to_rect_matrix(self) -> np.ndarray:
        """[3, 4] single matrix: velodyne -> rect (for on-device use)."""
        return self.R0 @ self.V2C

    def projection_matrix(self) -> np.ndarray:
        """[3, 4] velodyne -> image-plane projection for ops/frustum.py.

        The frustum sampler consumes velodyne-frame clouds; this composes
        P2 @ [R0 | 0] @ [V2C; 0 0 0 1].
        """
        r0_h = np.eye(4)
        r0_h[:3, :3] = self.R0
        v2c_h = np.eye(4)
        v2c_h[:3, :4] = self.V2C
        return self.P2 @ r0_h @ v2c_h
