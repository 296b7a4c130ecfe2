"""Point-cloud file IO without dependencies (PCD), numpy only.

The port's own copy of what it needs from
``cloud_transformers_tpu/data/pointcloud_io.py``: ``read_pcd`` for the
ShapeNet .pcd partial and complete clouds, ascii and binary (uncompressed)
files.
"""

import numpy as np


def read_pcd(path):
    """Read xyz from an ascii or binary (uncompressed) PCD file -> [N, 3]."""
    with open(path, "rb") as f:
        header = {}
        while True:
            line = f.readline().decode("ascii", errors="ignore").strip()
            if line.startswith("#") or not line:
                continue
            key, _, value = line.partition(" ")
            header[key.upper()] = value
            if key.upper() == "DATA":
                break
        fields = header["FIELDS"].split()
        sizes = list(map(int, header["SIZE"].split()))
        types = header["TYPE"].split()
        counts = list(map(int, header.get(
            "COUNT", " ".join(["1"] * len(fields))).split()))
        n = int(header["POINTS"])
        np_types = {("F", 4): "f4", ("F", 8): "f8", ("I", 1): "i1",
                    ("I", 2): "i2", ("I", 4): "i4", ("U", 1): "u1",
                    ("U", 2): "u2", ("U", 4): "u4"}
        dtype = np.dtype([(name, np_types[(t, s)], (c,) if c > 1 else ())
                          for name, t, s, c in
                          zip(fields, types, sizes, counts)])
        mode = header["DATA"].split()[0]
        if mode == "ascii":
            data = np.loadtxt(f, dtype=np.float64, max_rows=n)
            xyz_idx = [fields.index(a) for a in ("x", "y", "z")]
            return data[:, xyz_idx].astype(np.float32)
        if mode == "binary":
            raw = np.frombuffer(f.read(dtype.itemsize * n), dtype=dtype,
                                count=n)
            return np.stack([raw["x"], raw["y"], raw["z"]],
                            -1).astype(np.float32)
        raise ValueError(f"unsupported PCD DATA mode {mode!r} in {path}")

