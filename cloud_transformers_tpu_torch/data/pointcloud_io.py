"""Point-cloud file IO without dependencies (PCD and PLY), numpy only.

The port's own copy of ``cloud_transformers_tpu/data/pointcloud_io.py``:
``read_pcd`` for the ShapeNet .pcd partial and complete clouds (ascii and
binary, uncompressed), ``read_ply`` for the what3d ground-truth clouds
(ascii and binary_little_endian) and ``write_pcd`` (ascii) for evaluation
dumps.
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



def read_ply(path):
    """Read vertex xyz from an ascii or binary_little_endian PLY -> [N, 3]."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path} is not a PLY file")
        fmt = None
        n_vertex = 0
        props = []
        in_vertex = False
        while True:
            line = f.readline().decode("ascii", errors="ignore").strip()
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element"):
                _, name, cnt = line.split()
                in_vertex = name == "vertex"
                if in_vertex:
                    n_vertex = int(cnt)
            elif line.startswith("property") and in_vertex:
                _, typ, name = line.split()
                props.append((name, typ))
            elif line == "end_header":
                break
        types = {"float": "f4", "float32": "f4", "double": "f8",
                 "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
                 "short": "i2", "ushort": "u2", "int": "i4", "int32": "i4",
                 "uint": "u4"}
        if fmt == "ascii":
            data = np.loadtxt(f, max_rows=n_vertex)
            if data.ndim == 1:
                data = data[None]
            idx = [i for i, (name, _) in enumerate(props)
                   if name in ("x", "y", "z")]
            return data[:, idx].astype(np.float32)
        if fmt == "binary_little_endian":
            dtype = np.dtype([(name, "<" + types[t]) for name, t in props])
            raw = np.frombuffer(f.read(dtype.itemsize * n_vertex),
                                dtype=dtype, count=n_vertex)
            return np.stack([raw["x"], raw["y"], raw["z"]],
                            -1).astype(np.float32)
        raise ValueError(f"unsupported PLY format {fmt!r} in {path}")


def write_pcd(path, xyz):
    """Write an ascii PCD (for evaluation dumps)."""
    xyz = np.asarray(xyz, np.float32)
    with open(path, "w") as f:
        f.write("# .PCD v0.7 - Point Cloud Data file format\n"
                "VERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\n"
                "COUNT 1 1 1\n"
                f"WIDTH {len(xyz)}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
                f"POINTS {len(xyz)}\nDATA ascii\n")
        np.savetxt(f, xyz, fmt="%.6f")
