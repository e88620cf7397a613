"""Synthetic ray-traced TUM-format dataset generation.

The reference's primary artifact is a 573-frame fr1/desk trajectory
(cvo_main.cpp:36-66 looping assoc.txt; acceptance via
evaluate_ate.py:152-162), but its raw images are not vendored — only 5
downsampled clouds.  This module renders *exact-ground-truth* RGB-D
sequences of arbitrary length in the TUM folder layout (rgb/, depth/,
assoc.txt, groundtruth.txt), so sequence-scale odometry, SLAM and
loop-closure behavior can be validated end-to-end without the dataset.

World model: six horizontal depth bands (fixed world rectangles at
z in `depths`, defined by frame 0's frustum) with smooth per-channel
textures.  Frames are rendered by exact per-pixel ray/plane
intersection with z-buffering, so occlusion is correct and the ground
truth is closed-form.  Camera paths:

- `linear_orbit_path` — constant per-frame yaw+pitch about a pivot on
  the optical axis (the rotation-rich 6-frame fixture of
  tests/test_odometry_rotation.py).
- `revisit_path` — periodic yaw/pitch/translation: pose(i + period)
  equals pose(i) exactly, so the camera revisits earlier viewpoints
  every `period` frames — loop-closure candidates by construction.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from cvo_rgbd_tpu.frontend.camera import get_camera
from cvo_rgbd_tpu.io.tum import write_trajectory_line


def smooth_field(seed, h, w):
    """Smooth random texture channel in [0, 1] (band-limited noise)."""
    from scipy.ndimage import gaussian_filter, zoom

    r = np.random.default_rng(seed)
    b = zoom(gaussian_filter(r.normal(0, 1, (h // 4 + 2, w // 4 + 2)), 1.2),
             4.05)
    b = b[:h, :w]
    return (b - b.min()) / (b.max() - b.min())


def _rot_y(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def _rot_x(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])


@dataclasses.dataclass
class CameraPath:
    """Per-frame camera-to-world pose parameters.

    yaw/pitch [n] are rotations about a pivot on the optical axis;
    offset [n,3] is an extra world-frame camera-center displacement.
    """

    yaw: np.ndarray
    pitch: np.ndarray
    offset: np.ndarray

    @property
    def n_frames(self):
        return len(self.yaw)


def linear_orbit_path(n_frames, yaw_step_deg=0.8, pitch_step_deg=0.15):
    """Monotone orbit: frame i yaws i*yaw_step about the pivot."""
    i = np.arange(n_frames)
    return CameraPath(
        yaw=np.deg2rad(yaw_step_deg) * i,
        pitch=np.deg2rad(pitch_step_deg) * i,
        offset=np.zeros((n_frames, 3)),
    )


def revisit_path(n_frames, period=40, yaw_amp_deg=3.0, pitch_amp_deg=0.5,
                 trans_amp_m=0.04):
    """Periodic path: pose(i + period) == pose(i) exactly.

    Yaw, pitch and a lateral translation all follow sinusoids of the
    same period (different phases), so the camera sweeps away from and
    back through its earlier viewpoints — frames i and i+period are
    rendered from identical poses, giving guaranteed loop-closure
    opportunities with exact ground truth.
    """
    ph = 2 * np.pi * np.arange(n_frames) / period
    yaw = np.deg2rad(yaw_amp_deg) * np.sin(ph)
    pitch = np.deg2rad(pitch_amp_deg) * np.sin(ph + np.pi / 4)
    offset = trans_amp_m * np.stack(
        [np.sin(ph + np.pi / 3), 0.3 * np.sin(ph + 2 * np.pi / 3),
         0.2 * np.sin(ph)], axis=-1,
    )
    return CameraPath(yaw=yaw, pitch=pitch, offset=offset)


class BandScene:
    """The banded-depth world + ray-traced renderer."""

    def __init__(self, h=96, w=128, seq=1, depths=(1.0, 2.0, 4.0),
                 band_rows=16, u_pad=96, v_pad=24, texture_seeds=(11, 12, 13)):
        self.h, self.w = h, w
        self.cam = get_camera(seq)
        self.depths = depths
        self.band_rows = band_rows
        self.u_pad, self.v_pad = u_pad, v_pad
        self.n_bands = h // band_rows
        self.texture = np.stack(
            [
                40 + 200 * smooth_field(s, h + 2 * v_pad, w + 2 * u_pad)
                for s in texture_seeds
            ],
            axis=-1,
        ).astype(np.float32)
        # pivot on the optical axis of the (off-axis) frustum at 2 m
        self.pivot = np.array([
            2.0 * (w / 2 - self.cam.cx) / self.cam.fx,
            2.0 * (h / 2 - self.cam.cy) / self.cam.fy,
            2.0,
        ])

    def pose(self, path: CameraPath, i):
        """Camera-to-world (R, c) for frame i of `path`."""
        R = _rot_y(path.yaw[i]) @ _rot_x(path.pitch[i])
        c = self.pivot - R @ self.pivot + path.offset[i]
        return R, c

    def render(self, R_cam, c_cam):
        """Ray-trace one frame from camera-to-world pose (R, c).

        Returns (rgb [H,W,3] f32 in 0..255, z-depth [H,W] f32 meters).
        """
        h, w = self.h, self.w
        cam = self.cam
        fx, fy, cx, cy = cam.fx, cam.fy, cam.cx, cam.cy
        u, v = np.meshgrid(np.arange(w), np.arange(h))
        ray_c = np.stack(
            [(u - cx) / fx, (v - cy) / fy, np.ones_like(u, float)], axis=-1
        )
        ray_w = ray_c @ R_cam.T

        best_s = np.full((h, w), np.inf)
        rgb = np.zeros((h, w, 3), np.float32)
        tex = self.texture
        for b in range(self.n_bands):
            z_b = self.depths[b % len(self.depths)]
            s = (z_b - c_cam[2]) / ray_w[..., 2]
            X = c_cam[None, None, :] + s[..., None] * ray_w
            v0 = fy * X[..., 1] / z_b + cy       # frame-0 row of the hit
            u0 = fx * X[..., 0] / z_b + cx
            lo = b * self.band_rows - (self.v_pad if b == 0 else 0)
            hi = (b + 1) * self.band_rows + (
                self.v_pad if b == self.n_bands - 1 else 0
            )
            valid = (
                (s > 0) & (v0 >= lo) & (v0 < hi)
                & (u0 >= -self.u_pad) & (u0 < w + self.u_pad) & (s < best_s)
            )
            tv = np.clip(v0 + self.v_pad, 0, tex.shape[0] - 1.001)
            tu = np.clip(u0 + self.u_pad, 0, tex.shape[1] - 1.001)
            i0, j0 = tv.astype(int), tu.astype(int)
            av, au = (tv - i0)[..., None], (tu - j0)[..., None]
            samp = (
                tex[i0, j0] * (1 - av) * (1 - au)
                + tex[i0 + 1, j0] * av * (1 - au)
                + tex[i0, j0 + 1] * (1 - av) * au
                + tex[i0 + 1, j0 + 1] * av * au
            )
            rgb = np.where(valid[..., None], samp, rgb)
            best_s = np.where(valid, s, best_s)

        depth = np.where(np.isfinite(best_s), best_s, 0.0)
        return rgb, depth


@dataclasses.dataclass
class Degradation:
    """Kinect-like sensor degradation for the synthetic renderer.

    The reference ingests REAL sensor data: quantized noisy depth with
    holes and texture-poor frames — that is what the Canny top-up
    refill exists for (pcd_generator.cpp:135-163) and why the MATLAB
    batch runner records NaN on failed pairs (rgbddataset_rkhs.m:49-81).
    A noise-free synthetic world never exercises either path; this
    model does.  All effects are deterministic per (seed, frame).

    - `depth_noise`: per-pixel Gaussian depth noise with the Kinect
      disparity-quantization scaling sigma_z = depth_noise * z^2
      (Khoshelham & Elberink 2012 measure ~1.4e-3 * z^2 m for the
      Kinect-1 TUM sensor; the default 2e-3 is slightly worse).
    - `dropout`: fraction of DEPTH pixels zeroed in smooth blobs
      (invalid-return holes, like specular/oblique surfaces).
    - `low_texture_frames`: frame indices whose RGB contrast is crushed
      by `low_texture_scale` — the DSO selector's gradient histograms
      starve and the block-distributed refill (the Canny top-up analog,
      frontend/selector.py) must fill the quota.
    - `drop_frames`: frame indices with depth fully zeroed (total
      sensor dropout): the frontend yields an empty cloud and the
      drivers' skip-and-mark failure path must fire.
    """

    depth_noise: float = 2e-3
    dropout: float = 0.0
    low_texture_frames: tuple = ()
    low_texture_scale: float = 0.04
    drop_frames: tuple = ()
    seed: int = 0

    def apply(self, i, rgb, depth):
        """Degrade one rendered frame (returns new rgb, depth)."""
        r = np.random.default_rng(self.seed * 100003 + i)
        if i in self.low_texture_frames:
            rgb = 128.0 + (rgb - 128.0) * self.low_texture_scale
        if self.depth_noise > 0:
            valid = depth > 0
            depth = np.where(
                valid,
                depth + r.normal(size=depth.shape) * self.depth_noise
                * depth * depth,
                0.0,
            )
            depth = np.clip(depth, 0.0, None)  # negative = invalid (0)
        if self.dropout > 0:
            # smooth blob holes: threshold band-limited noise at the
            # dropout quantile (correlated invalid-return regions, not
            # salt-and-pepper)
            from scipy.ndimage import gaussian_filter

            field = gaussian_filter(
                r.normal(size=depth.shape), 3.0, mode="wrap"
            )
            depth = np.where(
                field < np.quantile(field, self.dropout), 0.0, depth
            )
        if i in self.drop_frames:
            depth = np.zeros_like(depth)
        return rgb, depth


def make_tum_dataset(root, path: CameraPath, scene: BandScene | None = None,
                     start_time=200.0, frame_dt=0.1,
                     degrade: Degradation | None = None):
    """Render `path` into a TUM-layout dataset folder at `root`.

    Writes rgb/<t>.png (8-bit), depth/<t>.png (16-bit, camera depth
    scale), assoc.txt, groundtruth.txt.  Returns (scene, poses) where
    poses is [n,4,4] camera-to-world ground truth.  `degrade` applies
    the sensor-degradation model per frame before writing.
    """
    from cvo_rgbd_tpu.io.png import write_png

    scene = scene or BandScene()
    root = str(root)
    os.makedirs(os.path.join(root, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(root, "depth"), exist_ok=True)

    lines = []
    poses = []
    with open(os.path.join(root, "groundtruth.txt"), "w") as gt:
        gt.write("# ground truth\n")
        for i in range(path.n_frames):
            R, c = scene.pose(path, i)
            rgb, depth = scene.render(R, c)
            if degrade is not None:
                rgb, depth = degrade.apply(i, rgb, depth)
            t = start_time + frame_dt * i
            name = f"{t:.6f}"
            write_png(os.path.join(root, "rgb", f"{name}.png"),
                      rgb.astype(np.uint8))
            write_png(os.path.join(root, "depth", f"{name}.png"),
                      (depth * scene.cam.scaling_factor).astype(np.uint16))
            lines.append(f"{name} rgb/{name}.png {name} depth/{name}.png")
            pose = np.eye(4)
            pose[:3, :3] = R
            pose[:3, 3] = c
            poses.append(pose)
            write_trajectory_line(gt, name, pose)
    with open(os.path.join(root, "assoc.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return scene, np.stack(poses)
