"""TAU Spatial Sound Events 2019 dataset: download, extraction, label parsing
(counterpart of ``sed_tpu.io.tau``).

Reference: dataset/download_tau_sed_2019.py (Zenodo URLs/md5s, unzip shellouts)
and dataset/dataset_utils.py:42-60 (per-wav CSV label parsing).  This version
uses only the stdlib (urllib, zipfile, hashlib) — no torchvision, no
subprocess unzip — with the same Zenodo artifact list, md5 gating, and
idempotence-by-directory-existence behavior.  The per-wav label CSVs are
read with the stdlib ``csv`` module rather than pandas.
"""

from __future__ import annotations

import csv
import hashlib
import os
import shutil
import urllib.request
import zipfile

import numpy as np

from sed_tpu_torch.configs import DEFAULT_AUDIO, AudioConfig
from sed_tpu_torch.io.labels import LabeledAudio

# Zenodo artifacts (download_tau_sed_2019.py:8-31).
FOA_ARTIFACTS = [
    ("https://zenodo.org/record/2599196/files/foa_dev.z01?download=1",
     "bd5b18a47a3ed96e80069baa6b221a5a", "foa_dev.z01"),
    ("https://zenodo.org/record/2599196/files/foa_dev.z02?download=1",
     "5194ebf43ae095190ed78691ec9889b1", "foa_dev.z02"),
    ("https://zenodo.org/record/2599196/files/foa_dev.zip?download=1",
     "2154ad0d9e1e45bfc933b39591b49206", "foa_dev.zip"),
    ("https://zenodo.org/record/2599196/files/metadata_dev.zip?download=1",
     "c2e5c8b0ab430dfd76c497325171245d", "metadata_dev.zip"),
    ("https://zenodo.org/record/3377088/files/foa_eval.zip?download=1",
     "4a8ca8bfb69d7c154a56a672e3b635d5", "foa_eval.zip"),
    ("https://zenodo.org/record/3377088/files/metadata_eval.zip?download=1",
     "a0ec7640284ade0744dfe299f7ba107b", "metadata_eval.zip"),
]


def _md5(path: str) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def download_foa_data(data_dir: str, fold_name: str = "eval") -> None:
    """Download the Zenodo archives (eval fold = last two artifacts only,
    download_tau_sed_2019.py:33-34), skipping files whose md5 already matches."""
    artifacts = FOA_ARTIFACTS[-2:] if fold_name == "eval" else FOA_ARTIFACTS
    os.makedirs(data_dir, exist_ok=True)
    for url, md5, name in artifacts:
        dest = os.path.join(data_dir, name)
        if os.path.exists(dest) and _md5(dest) == md5:
            print(f"Using downloaded and verified file: {dest}")
            continue
        print(f"Downloading {url} -> {dest}")
        urllib.request.urlretrieve(url, dest)
        got = _md5(dest)
        if got != md5:
            raise RuntimeError(f"md5 mismatch for {name}: expected {md5}, got {got}")


def _unzip(archive: str, output_dir: str) -> None:
    with zipfile.ZipFile(archive) as zf:
        zf.extractall(output_dir)


def _merge_split_zip(parts: list, merged: str) -> None:
    """Byte-concatenate zip spanned parts (.z01, .z02, .zip) into one stream.

    NOTE: the result is NOT a valid single-disk zip (central-directory entries
    still carry per-disk numbers and disk-relative offsets — the reference's
    ``zip -s 0`` shellout rewrote those, download_tau_sed_2019.py:52).  Use
    :func:`extract_split_zip`, which resolves entries against the disk offsets
    directly, to actually extract.
    """
    with open(merged, "wb") as out:
        for part in parts:
            with open(part, "rb") as f:
                shutil.copyfileobj(f, out)


def extract_split_zip(parts: list, output_dir: str) -> None:
    """Extract a spanned zip archive (.z01, .z02, ..., .zip) without ``zip -s 0``.

    Spanned archives store, per central-directory entry, the starting disk
    number and the offset *within that disk*; after byte concatenation those
    offsets must be rebased by the cumulative disk sizes.  This parses the
    (ZIP64-aware) end-of-central-directory records from the final part,
    rebases every entry, and inflates it with zlib — pure stdlib, handles the
    >4 GB foa_dev archives.
    """
    import io
    import struct
    import zlib

    sizes = [os.path.getsize(p) for p in parts]
    disk_base = [0]
    for sz in sizes[:-1]:
        disk_base.append(disk_base[-1] + sz)
    total = disk_base[-1] + sizes[-1]

    class _Span:
        """Random-access reader over the concatenated parts."""

        def __init__(self):
            self.files = [open(p, "rb") for p in parts]

        def read_at(self, offset: int, n: int) -> bytes:
            out = bytearray()
            while n > 0:
                disk = max(i for i, b in enumerate(disk_base) if b <= offset)
                local = offset - disk_base[disk]
                avail = sizes[disk] - local
                take = min(n, avail)
                self.files[disk].seek(local)
                out += self.files[disk].read(take)
                offset += take
                n -= take
            return bytes(out)

        def close(self):
            for f in self.files:
                f.close()

    span = _Span()
    try:
        # End-of-central-directory: search the tail of the final disk.
        tail_len = min(sizes[-1], 66000)
        tail = span.read_at(total - tail_len, tail_len)
        eocd_pos = tail.rfind(b"PK\x05\x06")
        if eocd_pos < 0:
            raise ValueError("EOCD signature not found; not a zip archive")
        eocd = tail[eocd_pos:eocd_pos + 22]
        (_, _, _, _, n_entries, cd_size, cd_offset, _) = struct.unpack(
            "<IHHHHIIH", eocd
        )
        cd_disk = struct.unpack("<H", eocd[6:8])[0]

        if n_entries == 0xFFFF or cd_offset == 0xFFFFFFFF or cd_size == 0xFFFFFFFF:
            # ZIP64: locator sits immediately before the EOCD.
            loc = tail[eocd_pos - 20:eocd_pos]
            if loc[:4] != b"PK\x06\x07":
                raise ValueError("ZIP64 EOCD locator missing")
            _, z64_disk, z64_off, _ = struct.unpack("<IIQI", loc)
            z64 = span.read_at(disk_base[z64_disk] + z64_off, 56)
            if z64[:4] != b"PK\x06\x06":
                raise ValueError("ZIP64 EOCD record missing")
            (_, _, _, _, _, _, _, n_entries, cd_size, cd_offset) = struct.unpack(
                "<IQHHIIQQQQ", z64
            )
            cd_disk = struct.unpack("<I", z64[20:24])[0]

        cd = span.read_at(disk_base[cd_disk] + cd_offset, cd_size)
        pos = 0
        os.makedirs(output_dir, exist_ok=True)
        for _ in range(n_entries):
            if cd[pos:pos + 4] != b"PK\x01\x02":
                raise ValueError("central directory corrupt")
            (method, comp_size, uncomp_size, name_len, extra_len, comment_len,
             disk_no, rel_off) = struct.unpack(
                "<HIIHHHHI",
                cd[pos + 10:pos + 12] + cd[pos + 20:pos + 28]
                + cd[pos + 28:pos + 34] + cd[pos + 34:pos + 36]
                + cd[pos + 42:pos + 46],
            )
            name = cd[pos + 46:pos + 46 + name_len].decode("utf-8", "replace")
            extra = cd[pos + 46 + name_len:pos + 46 + name_len + extra_len]
            # ZIP64 extra field overrides 0xFFFFFFFF placeholders, in order:
            # uncompressed size, compressed size, offset, disk number.
            e = 0
            while e + 4 <= len(extra):
                tag, ln = struct.unpack("<HH", extra[e:e + 4])
                if tag == 0x0001:
                    body = extra[e + 4:e + 4 + ln]
                    b = 0
                    if uncomp_size == 0xFFFFFFFF:
                        uncomp_size = struct.unpack("<Q", body[b:b + 8])[0]; b += 8
                    if comp_size == 0xFFFFFFFF:
                        comp_size = struct.unpack("<Q", body[b:b + 8])[0]; b += 8
                    if rel_off == 0xFFFFFFFF:
                        rel_off = struct.unpack("<Q", body[b:b + 8])[0]; b += 8
                    if disk_no == 0xFFFF:
                        disk_no = struct.unpack("<I", body[b:b + 4])[0]
                e += 4 + ln
            pos += 46 + name_len + extra_len + comment_len

            abs_off = disk_base[disk_no] + rel_off
            lh = span.read_at(abs_off, 30)
            if lh[:4] != b"PK\x03\x04":
                raise ValueError(f"local header not found for {name}")
            lh_name_len, lh_extra_len = struct.unpack("<HH", lh[26:30])
            data_off = abs_off + 30 + lh_name_len + lh_extra_len

            dest = os.path.join(output_dir, name)
            root = os.path.realpath(output_dir)
            if os.path.commonpath([os.path.realpath(dest), root]) != root:
                raise ValueError(f"unsafe path in archive: {name}")
            if name.endswith("/"):
                os.makedirs(dest, exist_ok=True)
                continue
            os.makedirs(os.path.dirname(dest) or output_dir, exist_ok=True)
            with open(dest, "wb") as out:
                if method == 0:  # stored
                    remaining = comp_size
                    off = data_off
                    while remaining > 0:
                        chunk = span.read_at(off, min(remaining, 1 << 24))
                        out.write(chunk)
                        off += len(chunk)
                        remaining -= len(chunk)
                elif method == 8:  # deflate
                    d = zlib.decompressobj(-15)
                    remaining = comp_size
                    off = data_off
                    while remaining > 0:
                        chunk = span.read_at(off, min(remaining, 1 << 24))
                        out.write(d.decompress(chunk))
                        off += len(chunk)
                        remaining -= len(chunk)
                    out.write(d.flush())
                else:
                    raise ValueError(f"unsupported compression method {method} for {name}")
    finally:
        span.close()


def extract_foa_data(data_dir: str, output_dir: str, fold_name: str = "eval") -> None:
    """Extract archives, flattening Zenodo's nested proj/.../foa_eval layout
    (download_tau_sed_2019.py:41-53)."""
    os.makedirs(output_dir, exist_ok=True)
    _unzip(os.path.join(data_dir, "metadata_eval.zip"), output_dir)
    _unzip(os.path.join(data_dir, "foa_eval.zip"), output_dir)

    nested = os.path.join(output_dir, "proj", "asignal", "DCASE2019", "dataset", "foa_eval")
    if os.path.isdir(nested):
        target = os.path.join(output_dir, "foa_eval")
        os.makedirs(target, exist_ok=True)
        for name in os.listdir(nested):
            shutil.copy2(os.path.join(nested, name), target)
        shutil.rmtree(os.path.join(output_dir, "proj"))

    if fold_name == "train":
        _unzip(os.path.join(data_dir, "metadata_dev.zip"), output_dir)
        extract_split_zip(
            [os.path.join(data_dir, n) for n in ("foa_dev.z01", "foa_dev.z02", "foa_dev.zip")],
            output_dir,
        )


def ensure_tau_data(data_dir: str, fold_name: str = "eval"):
    """Idempotent download+extract; returns (audio_dir, meta_data_dir).

    Reference: download_tau_sed_2019.py:56-71.
    """
    zipped_data_dir = os.path.join(data_dir, "zipped")
    extracted_data_dir = os.path.join(data_dir, "raw")
    audio_dir = f"{extracted_data_dir}/foa_{fold_name}"
    meta_data_dir = f"{extracted_data_dir}/metadata_{fold_name}"

    if os.path.exists(audio_dir) and os.path.exists(meta_data_dir):
        # Deliberate divergence: the reference re-downloads whenever the
        # zipped/ dir is missing even though extracted data already exists
        # (download_tau_sed_2019.py:63-64); complete existing raw data wins.
        print("Using existing raw data")
        return audio_dir, meta_data_dir

    if not os.path.exists(zipped_data_dir):
        print("Downloading zipped data")
        download_foa_data(zipped_data_dir, fold_name)
    print("Extracting raw data")
    extract_foa_data(zipped_data_dir, extracted_data_dir, fold_name)

    return audio_dir, meta_data_dir


def get_tau_sed_paths_and_labels(
    audio_dir: str,
    labels_data_dir: str,
    cfg: AudioConfig = DEFAULT_AUDIO,
):
    """Per-wav CSV -> (audio_path, start_times, end_times, bare_name) tuples,
    keeping only rows whose event class is in ``cfg.tau_sed_labels``.

    Reference: dataset/dataset_utils.py:42-60.  Deliberate divergence
    (PARITY.md "Known divergences"): the reference drops each kept row's
    ``sound_event_recording`` identity, which makes every class column train
    on the union signal when classes_num > 1; here the per-event class index
    into ``cfg.tau_sed_labels`` rides the returned :class:`LabeledAudio` so
    downstream rasterization can paint the correct column.
    """
    label_to_index = {label: i for i, label in enumerate(cfg.tau_sed_labels)}
    results = []
    for audio_fname in sorted(os.listdir(audio_dir)):
        bare_name = os.path.splitext(audio_fname)[0]
        audio_path = os.path.join(audio_dir, audio_fname)
        with open(os.path.join(labels_data_dir, bare_name + ".csv"), newline="") as f:
            rows = [r for r in csv.DictReader(f)
                    if r["sound_event_recording"] in label_to_index]
        start_times = np.array([float(r["start_time"]) for r in rows], dtype=np.float64)
        end_times = np.array([float(r["end_time"]) for r in rows], dtype=np.float64)
        class_indices = np.array(
            [label_to_index[r["sound_event_recording"]] for r in rows], dtype=np.int64)
        results.append(LabeledAudio(audio_path, start_times, end_times,
                                    bare_name, class_indices))
    return results
