"""Experiment runner: the training loop, checkpoints, scalar logs,
validation images and mesh extraction, on one device or on every rank of a
process group (``parallel/``).

The port's counterpart of ``rnb_tpu/train/runner.py``:

  * two step functions (warm-up, main), switched at ``warm_up_iter``;
  * every host draw is a function of (seed, step): the view order is a
    permutation seeded by (seed, epoch), copied from the JAX package so both
    train the same view sequence; the pixel, ``t_rand`` and ``t_out`` draws
    of step s come from a generator seeded afresh from (seed, s). A run
    resumed with ``is_continue`` draws what an uninterrupted one draws;
  * the step's 0-d metric tensors stay on the device and are fetched once
    every ``RING`` steps, so the loop does not wait on the card after each
    step; the NaN guard reads them there;
  * atomic checkpoints (``utils/checkpoint.py``) in the JAX package's
    layout, ``logs/scalars.jsonl``, validation images, ``meshes/*.ply``;
  * with ``RNB_PROFILE_DIR`` set, a ``torch.profiler`` trace of
    ``RNB_PROFILE_STEPS`` steps from step ``RNB_PROFILE_START`` (20 and 20
    by default), written there as a Chrome trace;
  * in a process group (a torchrun launch, ``parallel/mesh.py``), the
    data-parallel step of ``parallel/train.py`` with the exact global loss,
    on replicated data, or with ``train.view_shard`` and world > 1 on each
    rank's own views, read from disk by that rank alone
    (``parallel/data.py``). Rank r takes rows [r·B/W, (r+1)·B/W) of the
    step's global pixel, ``t_rand`` and ``t_out`` draws, so a W-rank run on
    replicated data is the one-rank run up to the order of its sums (the
    port's counterpart of the JAX package's ``fold_in(axis_index)``, whose
    threefry draws it cannot reproduce). The chief alone writes scalars,
    checkpoints, the source backup and meshes; every rank loads the same
    checkpoint and enters the sharded grid query (``parallel/grid.py``);
    under view sharding every rank validates views of its own shard;
  * the inference path: per-light validation images
    (``validate_image_ps``), a mesh with albedo vertex colours
    (``validate_mesh_texture``), novel views between two cameras
    (``render_novel_image``) and a video of them (``interpolate_view``).
"""

from __future__ import annotations

import json
import logging as pylog
import os
import shutil
import time

import numpy as np
import torch

from rnb_tpu_torch import config as cfglib
from rnb_tpu_torch.data import dataset as ds
from rnb_tpu_torch.models import fields, renderer as rnd
from rnb_tpu_torch.ops import marching_cubes as mc
from rnb_tpu_torch.parallel import data as pdata, mesh as meshlib
from rnb_tpu_torch.parallel import train as ptrain
from rnb_tpu_torch.train import schedules, step as steplib
from rnb_tpu_torch.utils import checkpoint as ckptlib
from rnb_tpu_torch.utils import io
from rnb_tpu_torch.utils.bridge import tree_leaves
from rnb_tpu_torch.utils.logging import ScalarLogger

logger = pylog.getLogger(__name__)

# the step's 0-d metric tensors, in the order of the JAX package's metrics
# ring (its last key, lr, is a host float here)
METRIC_KEYS = ("loss", "color_loss", "eikonal_loss", "mask_loss", "s_val",
               "cdf", "weight_max", "psnr")


def _pad_chunk(x, start: int, end: int, size: int):
    """Rows [start, end) of x, padded to ``size`` rows with the last one."""
    pad = size - (end - start)
    x = x[start:end]
    return torch.cat([x, x[-1:].expand(pad, *x.shape[1:])]) if pad else x


class _TraceWindow:
    """The ``RNB_PROFILE_*`` trace window of the training loop: a
    ``torch.profiler`` over steps [start, start + steps) with the CPU and,
    on the card, the CUDA activities; one synchronize at its end, then a
    Chrome trace in ``out_dir``."""

    def __init__(self, out_dir: str, device: torch.device):
        self.out_dir = out_dir
        self.start = int(os.environ.get("RNB_PROFILE_START", "20"))
        self.steps = int(os.environ.get("RNB_PROFILE_STEPS", "20"))
        self.device = device
        self.prof = None

    def before_step(self, it: int) -> None:
        """Open the window before step ``start``, close it before step
        ``start + steps``."""
        if it == self.start + self.steps:
            self.close()
        elif it == self.start:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.start()

    def close(self) -> None:
        """Stop the window (also where the loop ends inside it) and write
        the trace."""
        if self.prof is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prof.stop()
        os.makedirs(self.out_dir, exist_ok=True)
        path = os.path.join(self.out_dir, f"trace_{self.start:08d}_{self.steps}.json")
        self.prof.export_chrome_trace(path)
        self.prof = None
        logger.info("profiler trace written to %s", path)


class Runner:
    # steps between two fetches of the metrics; NaN detection trails the
    # live step by up to RING steps
    RING = 64

    def __init__(self, conf_path: str, mode: str = "train_rnb", case: str = "",
                 is_continue: bool = False, no_albedo: bool = False,
                 seed: int = 0, overrides: list[str] | None = None,
                 device="cuda", shard="auto"):
        self.conf_path = conf_path
        self.conf = cfglib.load_conf(conf_path, case)
        self.overrides = list(overrides or [])
        for ov in self.overrides:
            cfglib.apply_override(self.conf, ov)
        self.device = torch.device(device)
        self.base_exp_dir = self.conf.get_string("general.base_exp_dir")
        os.makedirs(self.base_exp_dir, exist_ok=True)

        self.tcfg = steplib.train_conf(self.conf)
        self.rcfg = steplib.apply_runtime_flags(
            rnd.renderer_conf(self.conf["model"]), self.tcfg)
        self.statics = fields.statics_from_conf(self.conf["model"])

        # the shard decision comes before the data loads: under view
        # sharding each rank reads only its own views
        self.parallel = torch.distributed.is_initialized()
        self.world, self.rank = meshlib.world(), meshlib.rank()
        self._is_chief = self.rank == 0
        meshlib.shard_width(shard, self.world)
        if self.tcfg.batch_size % self.world:
            raise ValueError(
                f"train.batch_size = {self.tcfg.batch_size} does not divide "
                f"by the world size {self.world}: every rank renders "
                "batch_size / world rays; set a batch size that divides")
        self.view_shard = bool(self.tcfg.view_shard and self.world > 1)
        if self.view_shard:
            self.dataset = pdata.load_view_sharded_dataset(
                self.conf["dataset"], self.rank, self.world, no_albedo,
                device=self.device)
            self._n_view_slots = len(pdata.pad_views(
                self.dataset.n_images_global, self.world)) // self.world
        else:
            self.dataset = ds.Dataset.from_conf(self.conf["dataset"], no_albedo,
                                                device=self.device)
            self._n_view_slots = self.dataset.n_images
        self.no_albedo = self.dataset.no_albedo

        params = fields.init_model_bundle(torch.Generator().manual_seed(seed),
                                          self.statics, self.device)
        self.state = steplib.init_train_state(params)
        self.seed = seed
        self._perm_epoch = None
        self._perm_cache = None
        self._gen = torch.Generator(device=self.device)
        self._step_fns = {}
        self._snap_good = None  # newest (step, leaves) confirmed finite

        if is_continue:
            latest = ckptlib.latest_checkpoint(
                os.path.join(self.base_exp_dir, "checkpoints"),
                self.tcfg.end_iter)
            if latest is not None:
                logger.info("Find checkpoint: %s", os.path.basename(latest))
                ckptlib.load_checkpoint(latest, self.state)

        if mode.startswith("train") and self._is_chief:
            self.file_backup()

    @property
    def iter_step(self) -> int:
        return self.state.step

    def get_cos_anneal_ratio(self) -> float:
        return schedules.cos_anneal_ratio(self.iter_step, self.tcfg.anneal_end)

    # -- host-side randomness, deterministic in (seed, step) ------------------

    def _host_draw(self, *stream) -> np.random.Generator:
        """A fresh Generator keyed on (seed, *stream), e.g. (step, tag)."""
        return np.random.default_rng([self.seed, *stream])

    def _view_for_step(self, it: int) -> int:
        """View trained at step ``it`` (under view sharding, a slot into
        every rank's local views): position it % N of a permutation seeded
        by (seed, epoch)."""
        n = self._n_view_slots
        epoch = it // n
        if self._perm_epoch != epoch:
            self._perm_cache = self._host_draw(epoch, 0).permutation(n)
            self._perm_epoch = epoch
        return int(self._perm_cache[it % n])

    def _step_generator(self, it: int) -> torch.Generator:
        """The generator of step ``it``'s pixel, t_rand and t_out draws,
        seeded afresh from (seed, it)."""
        return self._gen.manual_seed(int(self._host_draw(it, 3).integers(2 ** 62)))

    def _fixed_draws(self, n: int):
        """One (t_rand, t_out) draw of ``n`` rays, the same for every
        validation chunk and call."""
        g = torch.Generator(device=self.device).manual_seed(
            int(self._host_draw(0, 4).integers(2 ** 62)))
        t_rand = torch.rand((n, 1), generator=g, device=self.device) - 0.5
        t_out = None
        if self.rcfg.n_outside > 0:
            t_out = torch.rand((n, self.rcfg.n_outside), generator=g,
                               device=self.device)
        return t_rand, t_out

    def _rank_draws(self, it: int) -> dict:
        """This rank's rows [r·B/W, (r+1)·B/W) of step ``it``'s global
        draws, taken in the one-rank step's order."""
        _, H, W, _ = self.dataset.arrays.normals.shape
        bsz = self.tcfg.batch_size // self.world
        rows = slice(self.rank * bsz, (self.rank + 1) * bsz)
        got = steplib.draws(self._step_generator(it), self.tcfg.batch_size,
                            H, W, self.rcfg.n_outside)
        return dict(zip(("px", "py", "t_rand", "t_out"),
                        (None if x is None else x[rows] for x in got)))

    def _get_step_fn(self, warmup: bool):
        if warmup not in self._step_fns:
            make = (ptrain.make_view_sharded_train_step if self.view_shard
                    else ptrain.make_sharded_train_step if self.parallel
                    else steplib.make_train_step)
            self._step_fns[warmup] = make(self.statics, self.rcfg, self.tcfg,
                                          warmup, self.no_albedo)
        return self._step_fns[warmup]

    # -- training -------------------------------------------------------------

    def train_rnb(self) -> dict:
        """The training loop, from the state's step to ``end_iter``.
        Returns {"steps", "seconds", "rays_per_s"} of this call."""
        self.writer = ScalarLogger(os.path.join(self.base_exp_dir, "logs"),
                                   enabled=self._is_chief)
        self.writer.meta({"conf": self.conf_path, "overrides": self.overrides,
                          "flags": steplib.runtime_flags_dict(self.tcfg),
                          "device": str(self.device), "world": self.world,
                          "torch": torch.__version__})
        it = start_it = self.iter_step
        t_start = t_report = time.time()
        rays_done = 0
        self._report_rps = 0.0
        self._rps_at = {}      # report step -> rays/s measured at that step
        pending = []           # (step, metrics) not fetched yet
        self._last_snap = it
        self._snap_good = (it, ckptlib.state_leaves(self.state))
        prof_dir = os.environ.get("RNB_PROFILE_DIR", "")
        trace = (_TraceWindow(prof_dir, self.device)
                 if prof_dir and self._is_chief else None)
        try:
            while it < self.tcfg.end_iter:
                warmup = it < self.tcfg.warm_up_iter
                view = self._view_for_step(it)
                fn = self._get_step_fn(warmup)
                if trace:
                    trace.before_step(it)
                if self.parallel:
                    self.state, metrics = fn(self.state, self.dataset.arrays,
                                             view, **self._rank_draws(it))
                else:
                    self.state, metrics = fn(self.state, self.dataset.arrays,
                                             view, self._step_generator(it))
                it += 1
                pending.append((it, metrics))
                rays_done += self.tcfg.batch_size

                if it % self.tcfg.report_freq == 0:
                    dt = time.time() - t_report
                    self._report_rps = rays_done / max(dt, 1e-9)
                    self._rps_at[it] = self._report_rps
                    t_report, rays_done = time.time(), 0
                if it % self.RING == 0:
                    self._consume(pending)
                    pending = []

                if it % self.tcfg.save_freq == 0:
                    self.save_checkpoint()
                if it % self.tcfg.val_freq == 0:
                    self.validate_image()
                if it % self.tcfg.val_mesh_freq == 0:
                    self.validate_mesh()
            self._consume(pending)
        finally:
            if trace:
                trace.close()
            self._rps_at.clear()
            self.writer.close()
        secs = time.time() - t_start
        steps = it - start_it
        rps = steps * self.tcfg.batch_size / max(secs, 1e-9)
        if self._is_chief:
            print(f"trained {steps} steps in {secs:.3f} s ({rps:.0f} rays/s, "
                  "checkpoints and validation included)", flush=True)
        return {"steps": steps, "seconds": secs, "rays_per_s": rps}

    def _consume(self, pending) -> None:
        """Fetch the pending steps' metrics at once (this waits for the
        newest of them), guard them against NaN and log them. The metrics
        are global, so in a process group every rank stops at the same
        step."""
        if not pending:
            return
        rows = torch.stack([m[k].reshape(()).float() for _, m in pending
                            for k in METRIC_KEYS]).cpu().numpy()
        rows = rows.reshape(len(pending), len(METRIC_KEYS))
        for (s, metrics), row in zip(pending, rows):
            m = dict(zip(METRIC_KEYS, (float(v) for v in row)))
            m["lr"] = float(metrics["lr"])
            if not np.isfinite(m["loss"]):
                self._nan_guard(s, m)
            self.writer.log(s, {
                "Loss/loss": m["loss"],
                "Loss/color_loss": m["color_loss"],
                "Loss/eikonal_loss": m["eikonal_loss"],
                "Loss/mask_loss": m["mask_loss"],
                "Statistics/s_val": m["s_val"],
                "Statistics/cdf": m["cdf"],
                "Statistics/weight_max": m["weight_max"],
                "Statistics/psnr": m["psnr"],
                "lr": m["lr"],
            })
            if s % self.tcfg.report_freq == 0:
                rps = self._rps_at.pop(s, self._report_rps)
                self.writer.log(s, {"Perf/rays_per_s": rps})
            if s % self.tcfg.report_freq == 0 and self._is_chief:
                print(f"iter:{s:8d} loss={m['loss']:.5f} "
                      f"color={m['color_loss']:.5f} "
                      f"eik={m['eikonal_loss'] * self.tcfg.igr_weight:.5f} "
                      f"mask={m['mask_loss'] * self.tcfg.mask_weight:.5f} "
                      f"lr={m['lr']:.3e} rays/s={rps:.0f}", flush=True)
        # every fetched step is confirmed finite and the fetch waited for
        # the newest: the live state is a good snapshot (refreshed at most
        # every 2000 steps: a copy of the whole state to the host)
        end_it = pending[-1][0]
        if end_it - self._last_snap >= 2000:
            self._snap_good = (end_it, ckptlib.state_leaves(self.state))
            self._last_snap = end_it

    def _nan_guard(self, s: int, m: dict) -> None:
        """Write the live state and the last confirmed-finite one (the chief
        alone), then raise FloatingPointError."""
        ckpt_dir = os.path.join(self.base_exp_dir, "checkpoints")
        path = ckptlib.checkpoint_path(ckpt_dir, s, prefix="nan_dump_")
        good_it, good_leaves = self._snap_good
        good_path = ckptlib.checkpoint_path(ckpt_dir, good_it, prefix="last_good_")
        if self._is_chief:
            ckptlib.save_checkpoint(path, self.state)
            ckptlib.save_checkpoint(good_path, good_leaves)
        raise FloatingPointError(
            f"non-finite loss at iter {s}: {m}. NOTE the dump at {path} is "
            f"the LIVE state (iter {self.iter_step}, up to {self.RING} steps "
            f"PAST the NaN), diagnostic only; last confirmed-finite state "
            f"(iter {good_it}) saved to {good_path}. Rerun with "
            "RNB_DEBUG_NANS=1 to locate the op.")

    # -- checkpointing --------------------------------------------------------

    def save_checkpoint(self):
        if not self._is_chief:
            return  # the state is the same on every rank; one writer
        # NaN detection trails the live step, so a save could otherwise
        # persist non-finite params that a resume would start from
        if not self._params_finite():
            logger.error("skipping checkpoint at iter %d: non-finite params "
                         "(the NaN guard will fire on the next fetch)",
                         self.iter_step)
            return
        path = ckptlib.checkpoint_path(
            os.path.join(self.base_exp_dir, "checkpoints"), self.iter_step)
        ckptlib.save_checkpoint(path, self.state)

    def _params_finite(self) -> bool:
        leaves = tree_leaves(self.state.params)
        return bool(torch.stack([torch.isfinite(p).all() for p in leaves]).all())

    def file_backup(self):
        """Snapshot of the sources named by ``general.recording`` (their .py
        files), the conf and the resolved flags, for reproducibility."""
        dir_lis = self.conf.get_list("general.recording", default=[])
        rec_dir = os.path.join(self.base_exp_dir, "recording")
        os.makedirs(rec_dir, exist_ok=True)
        for dir_name in dir_lis:
            cur_dir = os.path.join(rec_dir, dir_name)
            os.makedirs(cur_dir, exist_ok=True)
            if not os.path.isdir(dir_name):
                continue
            for f_name in os.listdir(dir_name):
                src = os.path.join(dir_name, f_name)
                if f_name.endswith(".py") and os.path.isfile(src):
                    shutil.copyfile(src, os.path.join(cur_dir, f_name))
        shutil.copyfile(self.conf_path, os.path.join(rec_dir, "config.conf"))
        with open(os.path.join(rec_dir, "flags.json"), "w") as f:
            json.dump({"flags": steplib.runtime_flags_dict(self.tcfg),
                       "overrides": self.overrides}, f, indent=1)

    # -- validation: images ---------------------------------------------------

    def _render_view(self, idv: int, idl: int, resolution_level: int,
                     warmup: bool):
        """Chunked full-view render, no grad -> (rgb, normal) [H, W, 3] host
        arrays. The last chunk is padded with its edge ray; the weight norm
        is folded once for all chunks."""
        arrays = self.dataset.arrays
        rays_o, rays_d, px, py = ds.gen_rays_at(arrays, idv, resolution_level)
        H, W = rays_o.shape[:2]
        rays_o, rays_d = rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)
        pxi = torch.clamp(torch.round(px).long(), 0, self.dataset.W - 1).reshape(-1)
        pyi = torch.clamp(torch.round(py).long(), 0, self.dataset.H - 1).reshape(-1)

        bsz = self.tcfg.batch_size
        n_total = rays_o.shape[0]
        n_samples = (self.rcfg.total_samples if self.rcfg.n_importance > 0
                     else self.rcfg.n_samples)
        t_rand, t_out = self._fixed_draws(bsz)
        cos_r = self.get_cos_anneal_ratio()

        def chunk(x, start, end):
            return _pad_chunk(x, start, end, bsz)

        out_rgb, out_normal = [], []
        with torch.no_grad():
            params = fields.fold_params(self.state.params)
            for start in range(0, n_total, bsz):
                end = min(start + bsz, n_total)
                o, d = chunk(rays_o, start, end), chunk(rays_d, start, end)
                near, far = self.dataset.near_far_from_sphere(o, d)
                if warmup:
                    lights = arrays.lights_warmup_world[idv, idl].reshape(1, 1, 1, 3)
                else:
                    lights = ds.lights_at_pixels(
                        arrays, idv, idl, chunk(pxi, start, end),
                        chunk(pyi, start, end))[None, :, None, :]
                out = rnd.render_rnb(self.statics, self.rcfg, params,
                                     o, d, near, far, lights, t_rand, t_out,
                                     cos_anneal_ratio=cos_r,
                                     no_albedo=self.no_albedo, warmup=warmup)
                out_rgb.append(out["color_fine"][0][:end - start])
                out_normal.append(
                    (out["gradients"] * out["weights"][:, :n_samples, None]
                     * out["inside_sphere"][..., None]).sum(dim=1)[:end - start])
        img = torch.cat(out_rgb).reshape(H, W, 3).cpu().numpy()
        normal_img = torch.cat(out_normal).reshape(H, W, 3).cpu().numpy()
        return img, normal_img

    def validate_image(self, idv: int = -1, idl: int = -1,
                       resolution_level: int = -1):
        """Render a view under one light; save render‖supervision and
        normal‖supervision normal. The view and light are drawn from
        (seed, step), never from the training stream.

        In a process group with view sharding, every rank validates a view
        of its own shard, rotating with the step, under the file tag
        ``p<rank>`` (padded shards can repeat a global view across ranks);
        otherwise the data are replicated and the chief alone validates
        (the others return (None, None))."""
        rng = self._host_draw(self.iter_step, 1)
        if idl < 0:
            idl = int(rng.integers(self.dataset.n_lights))
        if idv < 0:
            if self.view_shard:
                idv = (self.iter_step // max(self.tcfg.val_freq, 1)
                       % self.dataset.n_images)
            else:
                idv = int(rng.integers(self.dataset.n_images))
        if not self._is_chief and not self.view_shard:
            return None, None
        if resolution_level < 0:
            resolution_level = self.tcfg.validate_resolution_level
        warmup = self.iter_step < self.tcfg.warm_up_iter
        gidv = getattr(self.dataset, "global_view_indices",
                       range(self.dataset.n_images))[idv]
        tag = f"p{self.rank}" if self.world > 1 else "0"
        print(f"Validate: iter: {self.iter_step}, camera: {gidv} (local {idv}), "
              f"light: {idl}", flush=True)
        img, normal_img = self._render_view(idv, idl, resolution_level, warmup)
        gt_warm, gt_main = self.dataset.image_at_ps(idv, idl, resolution_level)
        io.save_image(
            os.path.join(self.base_exp_dir, "validations_fine",
                         f"{self.iter_step:08d}_{tag}_{gidv}_{idl}.png"),
            np.concatenate([img, gt_warm if warmup else gt_main], axis=0))
        io.save_normal(
            os.path.join(self.base_exp_dir, "normals",
                         f"{self.iter_step:08d}_{tag}_{gidv}.png"),
            np.concatenate([normal_img,
                            self.dataset.normal_at(idv, resolution_level)], axis=0))
        return img, normal_img

    def validate_image_ps(self, idv: int = -1, resolution_level: int = -1):
        """Render one view under every light; save render‖supervision as
        ``validations_ps/<iter>_<idv>_<idl>.png``. The view is drawn from
        (seed, step). -> the renders, [H, W, 3] host arrays (the chief
        alone renders and writes; the other ranks return [])."""
        if idv < 0:
            idv = int(self._host_draw(self.iter_step, 2).integers(
                self.dataset.n_images))
        if not self._is_chief:
            return []
        if resolution_level < 0:
            resolution_level = self.tcfg.validate_resolution_level
        warmup = self.iter_step < self.tcfg.warm_up_iter
        imgs = []
        for idl in range(self.dataset.n_lights):
            img, _ = self._render_view(idv, idl, resolution_level, warmup)
            gt_warm, gt_main = self.dataset.image_at_ps(idv, idl, resolution_level)
            io.save_image(
                os.path.join(self.base_exp_dir, "validations_ps",
                             f"{self.iter_step:08d}_{idv}_{idl}.png"),
                np.concatenate([img, gt_warm if warmup else gt_main], axis=0))
            imgs.append(img)
        return imgs

    # -- validation: meshes ---------------------------------------------------

    def _extract(self, resolution: int, threshold: float):
        """Zero level set at ``resolution``³, in normalized space. In a
        process group the grid is split over the ranks, a collective that
        every rank enters."""
        if self.parallel:
            from rnb_tpu_torch.parallel.grid import extract_fields_sharded
            grid = extract_fields_sharded(self.statics, self.state.params,
                                          self.dataset.object_bbox_min,
                                          self.dataset.object_bbox_max,
                                          resolution)
        else:
            grid = rnd.extract_fields(self.statics, self.state.params,
                                      self.dataset.object_bbox_min,
                                      self.dataset.object_bbox_max, resolution)
        return mc.extract_geometry(grid, self.dataset.object_bbox_min,
                                   self.dataset.object_bbox_max, threshold)

    def _to_world(self, vertices):
        scale_mat = self.dataset.scale_mats_np[0]
        return vertices * scale_mat[0, 0] + scale_mat[:3, 3][None]

    def _mesh_path(self) -> str:
        return os.path.join(self.base_exp_dir, "meshes", f"{self.iter_step:08d}.ply")

    def validate_mesh(self, world_space: bool = False, resolution: int = 128,
                      threshold: float = 0.0):
        """Extract the zero level set at ``resolution``³ and write
        ``meshes/<iter>.ply`` (the chief); world_space rescales by the first
        scale mat."""
        vertices, triangles = self._extract(resolution, threshold)
        if world_space:
            vertices = self._to_world(vertices)
        if self._is_chief:
            io.write_ply(self._mesh_path(), vertices, triangles)
        return vertices, triangles

    def validate_mesh_texture(self, world_space: bool = True,
                              resolution: int = 128, threshold: float = 0.0):
        """``validate_mesh`` with RGB vertex colours: the albedo field at
        the normalized-space vertices (``_vertex_albedo``), before the
        world-space scaling. -> (vertices, triangles, albedo)."""
        vertices, triangles = self._extract(resolution, threshold)
        albedo = self._vertex_albedo(vertices)
        if world_space:
            vertices = self._to_world(vertices)
        if self._is_chief:
            io.write_ply(self._mesh_path(), vertices, triangles,
                         vertex_colors=albedo)
        return vertices, triangles, albedo

    def _vertex_albedo(self, vertices: np.ndarray,
                       chunk: int = 100000) -> np.ndarray:
        """Albedo [V, 3] in [0, 1] at each vertex, in chunks of ``chunk``
        (a ragged last one): the SDF core's (feature, ∇SDF), then the albedo
        net with the gradient standing in for the view direction, by the
        conf's route (``core_impl``: the fused ops at its ``kernel_prec``
        on 'pallas')."""
        out = np.empty((len(vertices), 3), np.float32)
        with torch.no_grad():
            params = fields.fold_params(self.state.params)
            for start in range(0, len(vertices), chunk):
                pts = torch.as_tensor(
                    np.asarray(vertices[start:start + chunk], np.float32),
                    device=self.device)
                _, feat, grad = rnd.sdf_feat_grad(self.statics, params, pts,
                                                  self.rcfg.kernel_prec,
                                                  self.rcfg.core_impl)
                alb = rnd.albedo_at(self.statics, params, pts, grad, grad, feat,
                                    self.rcfg.kernel_prec, self.rcfg.core_impl)
                out[start:start + len(pts)] = np.clip(alb.cpu().numpy(), 0, 1)
        return out

    # -- novel views ----------------------------------------------------------

    def render_novel_image(self, idx_0: int, idx_1: int, ratio: float,
                           resolution_level: int) -> np.ndarray:
        """The vanilla NeuS render (``renderer.render``) from a camera
        between views idx_0 and idx_1 (``Dataset.gen_rays_between``), in
        no-grad chunks of ``batch_size`` rays, the last one padded with its
        edge ray; the same draws for every chunk and call, the weight norm
        folded once for all chunks. -> uint8 [H/l, W/l, 3]."""
        rays_o, rays_d = self.dataset.gen_rays_between(idx_0, idx_1, ratio,
                                                       resolution_level)
        H, W = rays_o.shape[:2]
        rays_o, rays_d = rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)
        bsz = self.tcfg.batch_size
        t_rand, t_out = self._fixed_draws(bsz)
        background_rgb = (torch.ones(1, 3, device=self.device)
                          if self.tcfg.use_white_bkgd else None)
        cos_r = self.get_cos_anneal_ratio()
        out_rgb = []
        with torch.no_grad():
            params = fields.fold_params(self.state.params)
            for start in range(0, rays_o.shape[0], bsz):
                end = min(start + bsz, rays_o.shape[0])
                o = _pad_chunk(rays_o, start, end, bsz)
                d = _pad_chunk(rays_d, start, end, bsz)
                near, far = self.dataset.near_far_from_sphere(o, d)
                out = rnd.render(self.statics, self.rcfg, params,
                                 o, d, near, far, t_rand, t_out,
                                 cos_anneal_ratio=cos_r,
                                 background_rgb=background_rgb)
                out_rgb.append(out["color_fine"][:end - start])
        img = torch.cat(out_rgb).reshape(H, W, 3).cpu().numpy()
        return (np.clip(img, 0, 1) * 255).astype(np.uint8)

    def interpolate_view(self, img_idx_0: int, img_idx_1: int,
                         n_frames: int = 60) -> str:
        """``n_frames`` novel views at level 4 along a sine ramp from view
        img_idx_0 to img_idx_1, then the same frames reversed, as a 30 fps
        video ``render/<iter>_<i0>_<i1>.avi``. The JAX package writes mp4v
        through OpenCV; the card's machine has no OpenCV, so the port
        writes the same frames into an uncompressed AVI of its own
        (``utils/io.write_avi``), hence the other extension. -> the path
        (the chief alone renders and writes; the other ranks return None)."""
        if not self._is_chief:
            return None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        images = []
        for i in range(n_frames):
            ratio = np.sin(((i / n_frames) - 0.5) * np.pi) * 0.5 + 0.5
            images.append(self.render_novel_image(img_idx_0, img_idx_1, ratio,
                                                  resolution_level=4))
        secs = time.perf_counter() - t0
        h, w = images[0].shape[:2]
        print(f"rendered {n_frames} frames of {w}x{h} in {secs:.3f} s "
              f"({secs / n_frames * 1e3:.3f} ms a frame, "
              f"{n_frames * h * w / secs:.0f} rays/s)", flush=True)
        images += images[::-1]
        path = os.path.join(self.base_exp_dir, "render",
                            f"{self.iter_step:08d}_{img_idx_0}_{img_idx_1}.avi")
        io.write_avi(path, images, fps=30)
        return path
