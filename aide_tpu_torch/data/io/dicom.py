"""Minimal DICOM reader (uncompressed transfer syntaxes).

An own copy of ``aide_tpu.data.io.dicom``. The reference reads CHAOS MR
slices with ``pydicom.read_file(...).pixel_array``
(datasetchaos_proposed/dataset.py:24-30) and voxel spacing
tags (evalchaos_comparison_1cases.py:190-194). pydicom is not part of this
framework's dependency set, so a self-contained parser covers what the
datasets need: explicit/implicit-VR little-endian files with native
(uncompressed) PixelData, Rows/Columns/BitsAllocated/PixelRepresentation,
RescaleSlope/Intercept, PixelSpacing, SliceThickness.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np

_EXPLICIT_LONG_VRS = {b"OB", b"OW", b"OF", b"OD", b"OL", b"SQ", b"UT", b"UC", b"UR", b"UN"}

# tags we materialize (group, element) -> name
_TAGS = {
    (0x0028, 0x0010): "Rows",
    (0x0028, 0x0011): "Columns",
    (0x0028, 0x0100): "BitsAllocated",
    (0x0028, 0x0101): "BitsStored",
    (0x0028, 0x0103): "PixelRepresentation",
    (0x0028, 0x0002): "SamplesPerPixel",
    (0x0028, 0x0008): "NumberOfFrames",
    (0x0028, 0x0030): "PixelSpacing",
    (0x0028, 0x1052): "RescaleIntercept",
    (0x0028, 0x1053): "RescaleSlope",
    (0x0018, 0x0050): "SliceThickness",
    (0x0020, 0x0032): "ImagePositionPatient",
    (0x0020, 0x0013): "InstanceNumber",
    (0x0010, 0x0010): "PatientName",
    (0x0002, 0x0010): "TransferSyntaxUID",
}

_SUPPORTED_SYNTAXES = {
    "1.2.840.10008.1.2",      # implicit VR LE
    "1.2.840.10008.1.2.1",    # explicit VR LE
}

# Implicit-VR files carry no VR bytes; the VR comes from the data
# dictionary. Only the binary VRs need entries — every other tag we
# materialize (DS/IS/UI/PN) decodes correctly via the string fallback.
_IMPLICIT_VRS = {
    (0x0028, 0x0010): b"US",  # Rows
    (0x0028, 0x0011): b"US",  # Columns
    (0x0028, 0x0100): b"US",  # BitsAllocated
    (0x0028, 0x0101): b"US",  # BitsStored
    (0x0028, 0x0103): b"US",  # PixelRepresentation
    (0x0028, 0x0002): b"US",  # SamplesPerPixel
}


@dataclass
class DicomFile:
    tags: Dict[str, object] = field(default_factory=dict)
    pixel_data: bytes = b""

    @property
    def rows(self) -> int:
        return int(self.tags["Rows"])

    @property
    def columns(self) -> int:
        return int(self.tags["Columns"])

    @property
    def pixel_spacing(self) -> Optional[Tuple[float, float]]:
        ps = self.tags.get("PixelSpacing")
        if ps is None:
            return None
        parts = [float(x) for x in str(ps).split("\\")]
        return (parts[0], parts[1])

    @property
    def pixel_array(self) -> np.ndarray:
        """Raw stored values as (Rows, Columns), matching pydicom's
        ``pixel_array`` (no rescale applied)."""
        spp = int(self.tags.get("SamplesPerPixel", 1) or 1)
        if spp != 1:
            # RGB/multi-sample data would silently decode as the interleaved
            # top slice of the image — refuse like the other unsupported cases
            raise ValueError(f"unsupported SamplesPerPixel={spp} (expect 1)")
        frames = int(self.tags.get("NumberOfFrames", 1) or 1)
        if frames != 1:
            # a multi-frame file would otherwise silently decode as its
            # first frame; the CHAOS/task datasets are single-frame slices
            raise ValueError(
                f"unsupported NumberOfFrames={frames} (expect single-frame)"
            )
        bits = int(self.tags.get("BitsAllocated", 16))
        signed = int(self.tags.get("PixelRepresentation", 0)) == 1
        if bits == 16:
            dt = np.int16 if signed else np.uint16
        elif bits == 8:
            dt = np.int8 if signed else np.uint8
        elif bits == 32:
            dt = np.int32 if signed else np.uint32
        else:
            raise ValueError(f"unsupported BitsAllocated={bits}")
        arr = np.frombuffer(self.pixel_data, dtype=dt)
        n = self.rows * self.columns
        if arr.size < n:
            raise ValueError(
                f"PixelData holds {arr.size} values, need {n} "
                "(compressed transfer syntax?)"
            )
        return arr[:n].reshape(self.rows, self.columns)

    @property
    def rescaled_array(self) -> np.ndarray:
        slope = float(self.tags.get("RescaleSlope", 1.0) or 1.0)
        inter = float(self.tags.get("RescaleIntercept", 0.0) or 0.0)
        return self.pixel_array.astype(np.float32) * slope + inter


def _decode_value(vr: bytes, raw: bytes):
    if vr in (b"US",):
        # only the first value matters for our tags; slicing also keeps a
        # fuzzed odd-length element from tripping struct's exact-size check
        return struct.unpack("<H", raw[:2])[0] if len(raw) >= 2 else None
    if vr in (b"SS",):
        return struct.unpack("<h", raw[:2])[0] if len(raw) >= 2 else None
    if vr in (b"UL",):
        return struct.unpack("<I", raw[:4])[0] if len(raw) >= 4 else None
    if vr in (b"SL",):
        return struct.unpack("<i", raw[:4])[0] if len(raw) >= 4 else None
    if vr in (b"FL",):
        return struct.unpack("<f", raw[:4])[0] if len(raw) >= 4 else None
    if vr in (b"FD",):
        return struct.unpack("<d", raw[:8])[0] if len(raw) >= 8 else None
    # string-ish VRs (DS, IS, CS, UI, PN, LO, SH, DA, TM, ...)
    return raw.decode("ascii", errors="replace").strip("\x00 ").strip()


def read_dicom(path: str) -> DicomFile:
    with open(path, "rb") as fh:
        data = fh.read()
    if len(data) < 132 or data[128:132] != b"DICM":
        raise ValueError(f"{path}: not a DICOM part-10 file")

    out = DicomFile()
    i = 132
    n = len(data)
    explicit = True  # file meta group is always explicit VR LE
    syntax_checked = False

    while i + 8 <= n:
        group, elem = struct.unpack("<HH", data[i : i + 4])

        # after the group-0002 file meta, switch according to transfer syntax
        if not syntax_checked and group != 0x0002:
            syntax_checked = True
            ts = str(out.tags.get("TransferSyntaxUID", "1.2.840.10008.1.2.1"))
            if ts not in _SUPPORTED_SYNTAXES:
                raise ValueError(
                    f"{path}: unsupported transfer syntax {ts} "
                    "(only uncompressed little-endian is handled)"
                )
            explicit = ts != "1.2.840.10008.1.2"

        if explicit or group == 0x0002:
            vr = data[i + 4 : i + 6]
            if vr in _EXPLICIT_LONG_VRS:
                if i + 12 > n:
                    raise ValueError(f"{path}: truncated DICOM element header")
                length = struct.unpack("<I", data[i + 8 : i + 12])[0]
                hdr = 12
            else:
                length = struct.unpack("<H", data[i + 6 : i + 8])[0]
                hdr = 8
        else:
            vr = _IMPLICIT_VRS.get((group, elem), b"UN")
            length = struct.unpack("<I", data[i + 4 : i + 8])[0]
            hdr = 8

        if length == 0xFFFFFFFF:
            raise ValueError(f"{path}: undefined-length element (encapsulated?)")
        if i + hdr + length > n:
            # a short read would silently hand back a partial value (for
            # PixelData: a partial image)
            raise ValueError(
                f"{path}: truncated DICOM element "
                f"({group:04x},{elem:04x}) (need {length} bytes)"
            )

        value = data[i + hdr : i + hdr + length]
        if (group, elem) == (0x7FE0, 0x0010):
            out.pixel_data = value
            break
        name = _TAGS.get((group, elem))
        if name:
            out.tags[name] = _decode_value(vr, value)
        i += hdr + length

    return out
