"""Raw array file formats: CSV, FITS-like, and HDF5-like binary tables.

The paper stores sparse arrays as *tables* of (dimension..., attribute...)
tuples in all three formats (§4.1 Data: "Each tuple in HDF5 and FITS contains
the dimensions and attributes for each cell"). CFITSIO/libhdf5 are not
available offline, so we implement byte-level table formats that preserve the
semantics that matter to the caching framework:

  * files are unorganized along array dimensions -> any cell access requires
    a full scan + decode;
  * the three formats differ only in their decode constant and on-disk size
    (§4.3 "The file format has only a constant factor impact").

``fits`` mimics FITS binary tables: 2880-byte header blocks of 80-char ASCII
cards, big-endian records. ``hdf5`` mimics an HDF5 packet table: magic +
little-endian records with a small binary superblock. ``csv`` is real CSV.
"""
from __future__ import annotations

import io
import os
import struct
from typing import Tuple

import numpy as np

FORMATS = ("csv", "fits", "hdf5")

_FITS_BLOCK = 2880
_HDF5_MAGIC = b"\x89HDF\r\n\x1a\n"
_HDF5_VERSION = 1


def _check(ndim: int, nattr: int) -> None:
    if ndim < 1 or nattr < 0:
        raise ValueError(f"bad table schema ndim={ndim} nattr={nattr}")


# ------------------------------------------------------------------- CSV ---

def write_csv(path: str, coords: np.ndarray, attrs: np.ndarray) -> int:
    """Write a CSV table (header + one row per cell); returns bytes."""
    n, d = coords.shape
    m = attrs.shape[1]
    with open(path, "w") as f:
        f.write(",".join([f"dim{k}" for k in range(d)] +
                         [f"attr{k}" for k in range(m)]) + "\n")
        lines = []
        for i in range(n):
            row = [str(int(x)) for x in coords[i]] + \
                  [f"{float(x):.6g}" for x in attrs[i]]
            lines.append(",".join(row))
        f.write("\n".join(lines) + ("\n" if lines else ""))
    return os.path.getsize(path)


def read_csv(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Read a CSV table back into (int64 coords, float32 attrs)."""
    with open(path) as f:
        header = f.readline().strip().split(",")
        d = sum(1 for h in header if h.startswith("dim"))
        m = len(header) - d
        _check(d, m)
        raw = np.loadtxt(f, delimiter=",", dtype=np.float64, ndmin=2)
    if raw.size == 0:
        return (np.zeros((0, d), np.int64), np.zeros((0, m), np.float32))
    return raw[:, :d].astype(np.int64), raw[:, d:].astype(np.float32)


# ------------------------------------------------------------------ FITS ---

def _fits_card(key: str, value) -> bytes:
    if isinstance(value, str):
        v = f"'{value}'"
    else:
        v = str(value)
    return f"{key:<8}= {v:>20} /".ljust(80).encode("ascii")


def write_fits(path: str, coords: np.ndarray, attrs: np.ndarray) -> int:
    """Write a FITS-like binary table (big-endian); returns bytes."""
    n, d = coords.shape
    m = attrs.shape[1]
    _check(d, m)
    cards = [
        _fits_card("SIMPLE", "T"), _fits_card("BITPIX", 8),
        _fits_card("NAXIS", 2), _fits_card("NAXIS1", d * 8 + m * 4),
        _fits_card("NAXIS2", n), _fits_card("XTENSION", "BINTABLE"),
        _fits_card("TFIELDS", d + m), _fits_card("NDIM", d),
        _fits_card("NATTR", m),
        "END".ljust(80).encode("ascii"),
    ]
    header = b"".join(cards)
    header += b" " * (-len(header) % _FITS_BLOCK)
    body = io.BytesIO()
    # FITS binary tables are big-endian.
    body.write(coords.astype(">i8").tobytes())
    body.write(attrs.astype(">f4").tobytes())
    data = body.getvalue()
    data += b"\x00" * (-len(data) % _FITS_BLOCK)
    with open(path, "wb") as f:
        f.write(header)
        f.write(data)
    return os.path.getsize(path)


def read_fits(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Read a FITS-like binary table into (int64 coords, float32 attrs)."""
    with open(path, "rb") as f:
        blob = f.read()
    header = {}
    off = 0
    while off < len(blob):
        card = blob[off:off + 80].decode("ascii", errors="replace")
        off += 80
        if card.startswith("END"):
            break
        if "=" in card:
            key, rest = card.split("=", 1)
            header[key.strip()] = rest.split("/")[0].strip().strip("'").strip()
    data_off = ((off + _FITS_BLOCK - 1) // _FITS_BLOCK) * _FITS_BLOCK
    n = int(header["NAXIS2"]);  d = int(header["NDIM"]);  m = int(header["NATTR"])
    _check(d, m)
    coords = np.frombuffer(blob, dtype=">i8", count=n * d,
                           offset=data_off).reshape(n, d)
    attrs = np.frombuffer(blob, dtype=">f4", count=n * m,
                          offset=data_off + n * d * 8).reshape(n, m)
    return coords.astype(np.int64), attrs.astype(np.float32)


# ------------------------------------------------------------------ HDF5 ---

def write_hdf5(path: str, coords: np.ndarray, attrs: np.ndarray) -> int:
    """Write an HDF5-like packet table (little-endian); returns bytes."""
    n, d = coords.shape
    m = attrs.shape[1]
    _check(d, m)
    with open(path, "wb") as f:
        f.write(_HDF5_MAGIC)
        f.write(struct.pack("<IIII", _HDF5_VERSION, n, d, m))
        # Interleaved rows, little-endian — a packet-table-style layout.
        row = np.zeros((n, d * 2 + m), dtype=np.float64)
        # Store int64 dims bit-exactly inside float64 slots via view.
        dims64 = coords.astype("<i8").view("<f8")
        row[:, :d] = dims64
        row[:, d:2 * d] = 0.0  # reserved (chunk index words in real HDF5)
        row[:, 2 * d:] = attrs.astype(np.float64)
        f.write(row.astype("<f8").tobytes())
    return os.path.getsize(path)


def read_hdf5(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Read an HDF5-like packet table into (int64 coords, float32
    attrs)."""
    with open(path, "rb") as f:
        magic = f.read(8)
        if magic != _HDF5_MAGIC:
            raise ValueError(f"{path}: not an hdf5-like file")
        version, n, d, m = struct.unpack("<IIII", f.read(16))
        if version != _HDF5_VERSION:
            raise ValueError(f"unsupported version {version}")
        _check(d, m)
        row = np.frombuffer(f.read(n * (d * 2 + m) * 8),
                            dtype="<f8").reshape(n, d * 2 + m)
    coords = row[:, :d].copy().view("<i8").astype(np.int64)
    attrs = row[:, 2 * d:].astype(np.float32)
    return coords, attrs


# --------------------------------------------------------------- dispatch --

_WRITERS = {"csv": write_csv, "fits": write_fits, "hdf5": write_hdf5}
_READERS = {"csv": read_csv, "fits": read_fits, "hdf5": read_hdf5}

# Relative decode throughput (cells/sec scale) — the "constant factor impact"
# of the I/O library (§4.3). CSV tokenization is the slowest; binary formats
# decode faster, FITS pays byte-swapping on little-endian hosts.
DECODE_CELLS_PER_SEC = {"csv": 2.0e6, "fits": 12.0e6, "hdf5": 20.0e6}


def write_array_file(path: str, fmt: str, coords: np.ndarray,
                     attrs: np.ndarray) -> int:
    """Write one table in ``fmt`` (one of FORMATS); returns bytes."""
    if fmt not in FORMATS:
        raise ValueError(f"unknown format {fmt!r}")
    return _WRITERS[fmt](path, coords, attrs)


def read_array_file(path: str, fmt: str) -> Tuple[np.ndarray, np.ndarray]:
    """Read one table in ``fmt`` into (int64 coords, float32 attrs)."""
    if fmt not in FORMATS:
        raise ValueError(f"unknown format {fmt!r}")
    return _READERS[fmt](path)
