"""S3DIS under the KPConv/CloserLook3D protocol: grid-subsampled clouds,
potential-based sphere sampling, inputs padded to a fixed size with a 0/1
mask, and projections for full-cloud metrics.

Counterpart of ``cloud_transformers_tpu/data/s3dis_kpconv.py`` (the label
order is the reference's ``s3dis_closer.py``, chair/table and sofa/bookcase
swapped against the 1x1 protocol).  The pipeline:

1. parse the Area rooms into (points, colors, labels), cached as a pickle;
2. subsample each cloud on a ``subsampling_parameter`` voxel grid (the
   native subsampler of ``data/subsample.py``) and build a KD-tree on it;
3. the sphere schedule: pick the lowest-potential point, query its
   ``in_radius`` ball, raise the potentials there by Tukey weights; built
   lazily an epoch ahead by a daemon thread;
4. an item: the ball around the scheduled center (plus its cached noise),
   shuffled, padded to ``num_points`` by repeating its own points, with a
   0/1 mask;
5. projections from every full-resolution point to its nearest sub-cloud
   point, for the full-cloud metrics.

Steps 1, 2, 3's first epoch and 5 are the constructor's ``setup.data``
span (``utils/trace.py``).

Without a dataset a few random synthetic rooms stand in.

The JAX module's ``sklearn.neighbors.KDTree`` is ``scipy.spatial.cKDTree``
here (the card's machine has no scikit-learn), with sklearn's semantics:

* the ball (``ball``) holds the points whose squared distance, summed in
  float64 in axis order, is at most ``r * r``, as sklearn's leaf test
  reads (a point at exactly distance r is in it), sorted by the distance
  (the square root of that sum).  At an exact distance tie the order here
  is the points' index order (a stable sort); sklearn's sort is not
  stable, so the two may order a tie differently, and with it which
  points of a ball past ``num_points`` are kept and the item's point
  order.  The tests hold the items equal on the synthetic rooms;
* a projection (``nearest``) is ``cKDTree.query(k=1)``; where two sub-cloud
  points are exactly as near, either may be returned, as with sklearn.
"""

import os
import pickle
import threading

import numpy as np
from scipy.spatial import cKDTree

from cloud_transformers_tpu_torch.data.loader import item_rng
from cloud_transformers_tpu_torch.data.subsample import grid_subsampling
from cloud_transformers_tpu_torch.utils import trace

LABEL_NAMES = ["ceiling", "floor", "wall", "beam", "column", "window", "door",
               "chair", "table", "bookcase", "sofa", "board", "clutter"]
COLOR_MEAN = np.array([0.5136457, 0.49523646, 0.44921124])
COLOR_STD = np.array([0.18308958, 0.18415008, 0.19252081])
# the candidates of a ball come from cKDTree at a slightly larger radius;
# the exact test against r * r follows
_CANDIDATE_SLACK = 1.0 + 1e-6


def _synthetic_cloud(seed, n=40000):
    rng = np.random.RandomState(seed)
    pts = (rng.rand(n, 3) * np.array([8.0, 6.0, 3.0])).astype(np.float32)
    labels = np.clip((pts[:, 2] / 3.0 * 13).astype(np.int32), 0, 12)
    colors = rng.rand(n, 3).astype(np.float32) * 255
    return pts, colors, labels


def get_scene_seg_features(input_features_dim, pc, color, height):
    """Feature assembly by dimension code (the reference's
    ``s3dis_closer.py``), channel-last [N, F]."""
    if input_features_dim == 1:
        return height
    if input_features_dim == 3:
        return color
    if input_features_dim == 4:
        return np.concatenate([color, height], -1)
    if input_features_dim == 5:
        return np.concatenate([np.ones_like(height), color, height], -1)
    if input_features_dim == 6:
        return np.concatenate([color, pc], -1)
    if input_features_dim == 7:
        return np.concatenate([color, height, pc], -1)
    raise NotImplementedError(input_features_dim)


class BallTree:
    """The radius and nearest-point queries of the protocol on one
    sub-cloud, with sklearn ``KDTree``'s results (module docstring)."""

    def __init__(self, points):
        self.points = np.asarray(points, np.float64)
        self.tree = cKDTree(self.points, leafsize=50)

    def ball(self, pick, r):
        """Indices of the points within ``r`` of ``pick`` ([3] or [1, 3]),
        nearest first (ties by index)."""
        p = np.asarray(pick, np.float64).reshape(3)
        cand = np.asarray(self.tree.query_ball_point(
            p, r * _CANDIDATE_SLACK, return_sorted=True), np.intp)
        dx = self.points[cand] - p
        d2 = dx[:, 0] * dx[:, 0] + dx[:, 1] * dx[:, 1] + dx[:, 2] * dx[:, 2]
        keep = d2 <= r * r
        cand, d = cand[keep], np.sqrt(d2[keep])
        return cand[np.argsort(d, kind="stable")]

    def nearest(self, pts):
        """Index of the nearest point for each row of ``pts`` [N, 3]."""
        return self.tree.query(np.asarray(pts, np.float64), k=1)[1]


class S3DISSeg:
    """Items (channel-last): ``points [N,3]`` (centered on the pick point),
    ``mask [N]``, ``features [N,F]``, ``label [N]``, ``cloud_index []``,
    ``input_inds [N]``."""

    def __init__(self, input_features_dim=4, subsampling_parameter=0.04,
                 in_radius=2.0, num_points=8192, num_steps=2000,
                 num_epochs=600, color_drop=0.2, data_root=None,
                 split="train", seed=0, synthetic_clouds=2,
                 transforms=None):
        with trace.span("setup.data"):
            self.input_features_dim = input_features_dim
            self.in_radius = in_radius
            self.num_points = num_points
            self.num_steps = num_steps
            self.num_epochs = num_epochs
            self.color_drop = color_drop if split == "train" else 0.0
            self.split = split
            self.epoch = 0
            self.transforms = transforms
            self.seed = seed
            self._rng = np.random.RandomState(seed)

            train_clouds = ["Area_1", "Area_2", "Area_3", "Area_4", "Area_6"]
            val_clouds = ["Area_5"]
            names = (train_clouds if split == "train" else val_clouds
                     if split == "val" else val_clouds + train_clouds)

            cache_dir = (os.path.join(data_root, "processed") if data_root
                         else None)
            if cache_dir:
                os.makedirs(cache_dir, exist_ok=True)

            raw = []
            if data_root and any(os.path.isdir(os.path.join(data_root, n))
                                 for n in names):
                for name in names:
                    raw.append(self._parse_area(data_root, cache_dir, name))
            else:
                for i in range(synthetic_clouds):
                    raw.append(_synthetic_cloud(
                        i if split == "train" else 100 + i))

            self.clouds_points = [r[0] for r in raw]
            self.clouds_labels = [r[2] for r in raw]
            self.sub_points, self.sub_colors, self.sub_labels, self.trees = \
                [], [], [], []
            for pts, colors, labels in raw:
                sp, sc, sl = grid_subsampling(pts, colors, labels,
                                              sampleDl=subsampling_parameter)
                sc = sc / 255.0
                self.sub_points.append(sp)
                self.sub_colors.append(sc)
                self.sub_labels.append(sl)
                self.trees.append(BallTree(sp))

            self._build_schedule()
            # full-cloud projection: each raw point -> nearest sub-cloud point
            self.projections = [tree.nearest(pts).astype(np.int32)
                                for pts, tree in zip(self.clouds_points,
                                                     self.trees)]

    def _parse_area(self, data_root, cache_dir, name):
        cloud_file = os.path.join(cache_dir, name + ".pkl")
        if os.path.exists(cloud_file):
            with open(cloud_file, "rb") as f:
                return pickle.load(f)
        name_to_label = {n: i for i, n in enumerate(LABEL_NAMES)}
        pts_all, col_all, lab_all = [], [], []
        area_dir = os.path.join(data_root, name)
        for room in sorted(os.listdir(area_dir)):
            ann = os.path.join(area_dir, room, "Annotations")
            if not os.path.isdir(ann):
                continue
            for obj in sorted(os.listdir(ann)):
                if not obj.endswith(".txt"):
                    continue
                cls = obj[:-4].split("_")[0]
                label = name_to_label.get(cls, name_to_label["clutter"])
                arr = np.loadtxt(os.path.join(ann, obj), dtype=np.float32)
                if arr.ndim == 1:
                    arr = arr[None]
                pts_all.append(arr[:, :3])
                col_all.append(arr[:, 3:6])
                lab_all.append(np.full(arr.shape[0], label, np.int32))
        out = (np.concatenate(pts_all).astype(np.float32),
               np.concatenate(col_all).astype(np.float32),
               np.concatenate(lab_all))
        with open(cloud_file, "wb") as f:
            pickle.dump(out, f)
        return out

    def _build_schedule(self):
        """Potential-based sphere schedule (the reference's
        ``s3dis_closer.py``), generated lazily: ``set_epoch`` extends it
        through the requested epoch and a daemon thread builds the next
        epoch while the current one trains (the reference builds all
        epochs up front)."""
        self._sched_rng = self._rng
        self._potentials = [self._sched_rng.rand(p.shape[0]) * 1e-3
                            for p in self.sub_points]
        self._min_pot = [float(p.min()) for p in self._potentials]
        # one list of atomic (cloud_idx, point_idx, noise) tuples: a reader
        # whose length check passed never sees a torn entry
        self._schedule = []
        self._sched_lock = threading.Lock()
        self._prefetch_thread = None
        self._extend_schedule(self.num_steps)  # epoch 0 ready at once

    def _extend_schedule(self, until):
        """Generate schedule entries until there are ``until``.  The
        sequence is serial (each pick updates the potentials), but the lock
        is taken an entry at a time, so the next epoch's prefetch and
        ``__getitem__``'s catch-up interleave.  The work is the
        ``data.schedule`` span of the thread that does it."""
        if len(self._schedule) >= until:
            return
        with trace.span("data.schedule"):
            self._extend(until)

    def _extend(self, until):
        r_sq = self.in_radius ** 2
        while len(self._schedule) < until:
            with self._sched_lock:
                if len(self._schedule) >= until:
                    break
                rng = self._sched_rng
                ci = int(np.argmin(self._min_pot))
                pi = int(np.argmin(self._potentials[ci]))
                center = self.sub_points[ci][pi][None]
                noise = rng.normal(scale=self.in_radius / 10,
                                   size=center.shape)
                pick = center + noise.astype(center.dtype)
                q = self.trees[ci].ball(pick, self.in_radius)
                if self.num_points < q.shape[0]:
                    q = q[: self.num_points]
                d = np.sum((self.sub_points[ci][q] - pick) ** 2, axis=1)
                tukey = np.square(1 - d / r_sq)
                tukey[d > r_sq] = 0
                self._potentials[ci][q] += tukey
                self._min_pot[ci] = float(self._potentials[ci].min())
                self._schedule.append((ci, pi, noise.astype(np.float32)))

    @property
    def cloud_inds(self):
        """The cloud index of each schedule entry built so far."""
        return [e[0] for e in self._schedule]

    def set_epoch(self, epoch):
        self.epoch = epoch % self.num_epochs
        need = (self.epoch + 1) * self.num_steps
        self._extend_schedule(need)
        # build the next epoch in the background
        if self.epoch + 1 < self.num_epochs:
            if self._prefetch_thread is None or \
                    not self._prefetch_thread.is_alive():
                t = threading.Thread(
                    target=self._extend_schedule,
                    args=(need + self.num_steps,), daemon=True)
                t.start()
                self._prefetch_thread = t

    def __len__(self):
        return self.num_steps

    def __getitem__(self, idx):
        sched = idx + self.epoch * self.num_steps
        # entries are atomic tuples: the lock is needed only while the
        # schedule has not caught up
        if len(self._schedule) <= sched:
            self._extend_schedule(sched + 1)
        ci, pi, noise = self._schedule[sched]
        pick = self.sub_points[ci][pi][None] + noise
        rng = item_rng(self.seed, self.epoch, idx)
        q = self.trees[ci].ball(pick, self.in_radius)
        n = q.shape[0]
        if self.num_points < n:
            perm = rng.permutation(self.num_points)
            input_inds = q[: self.num_points][perm]
            mask = np.ones(self.num_points, np.float32)
        else:
            perm = rng.permutation(n)
            q = q[perm]
            pad = rng.choice(n, self.num_points - n)
            input_inds = np.concatenate([q, q[pad]])
            mask = np.zeros(self.num_points, np.float32)
            mask[:n] = 1

        original = self.sub_points[ci][input_inds]
        points = (original - pick).astype(np.float32)
        height = original[:, 2:].astype(np.float32)
        colors = ((self.sub_colors[ci][input_inds] - COLOR_MEAN)
                  / COLOR_STD).astype(np.float32)
        if self.color_drop and rng.rand() < self.color_drop:
            colors = colors * 0.0
        labels = self.sub_labels[ci][input_inds].astype(np.int32)
        if self.transforms is not None:
            points = self.transforms(points)
        features = get_scene_seg_features(self.input_features_dim, points,
                                          colors, height)
        return {"points": points, "mask": mask,
                "features": features.astype(np.float32), "label": labels,
                "cloud_index": np.int32(ci),
                "input_inds": input_inds.astype(np.int32)}
