"""Minimal PLY reader/writer (ascii + binary_little_endian).

The port's own copy of grendel_tpu/utils/ply.py (numpy only). Only the
"vertex" element with scalar properties is supported: that is all 3DGS
files ever contain.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

_PLY_TO_NP = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}
_NP_TO_PLY = {
    "int8": "char", "uint8": "uchar", "int16": "short", "uint16": "ushort",
    "int32": "int", "uint32": "uint", "float32": "float", "float64": "double",
}


def read_ply(path: str) -> Dict[str, np.ndarray]:
    """Read the vertex element of a PLY file into {property: (N,) array}."""
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        count = 0
        props: List[Tuple[str, str]] = []
        in_vertex = False
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: truncated header")
            tokens = line.decode("ascii", "replace").strip().split()
            if not tokens:
                continue
            if tokens[0] == "format":
                fmt = tokens[1]
            elif tokens[0] == "element":
                in_vertex = tokens[1] == "vertex"
                if in_vertex:
                    count = int(tokens[2])
            elif tokens[0] == "property" and in_vertex:
                if tokens[1] == "list":
                    raise ValueError("list properties unsupported")
                props.append((tokens[2], _PLY_TO_NP[tokens[1]]))
            elif tokens[0] == "end_header":
                break
        if fmt == "binary_little_endian":
            dtype = np.dtype([(n, "<" + t) for n, t in props])
            data = np.frombuffer(f.read(count * dtype.itemsize), dtype=dtype,
                                 count=count)
        elif fmt == "ascii":
            dtype = np.dtype([(n, t) for n, t in props])
            rows = [f.readline().split() for _ in range(count)]
            data = np.array([tuple(r) for r in rows], dtype=dtype)
        else:
            raise ValueError(f"unsupported PLY format {fmt}")
    return {n: np.ascontiguousarray(data[n]) for n, _ in props}


def write_ply(path: str, fields: Dict[str, np.ndarray]) -> None:
    """Write {property: (N,) array} as a binary_little_endian vertex PLY."""
    names = list(fields.keys())
    n = len(next(iter(fields.values())))
    dtype = np.dtype(
        [(name, "<" + np.dtype(fields[name].dtype).str[1:]) for name in names]
    )
    rec = np.empty(n, dtype=dtype)
    for name in names:
        arr = np.asarray(fields[name])
        if arr.shape != (n,):
            raise ValueError(f"field {name}: expected shape ({n},), got {arr.shape}")
        rec[name] = arr
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    for name in names:
        header.append(f"property {_NP_TO_PLY[np.dtype(fields[name].dtype).name]} {name}")
    header.append("end_header\n")
    with open(path, "wb") as f:
        f.write("\n".join(header).encode("ascii"))
        f.write(rec.tobytes())
