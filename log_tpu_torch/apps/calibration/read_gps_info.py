"""EXIF GPS of the images under a folder -> local metric ENU positions
around their mean ({relative name: xyz}, saved with np.save), for
align_with_gps. Reads EXIF through PIL.

    python -m log_tpu_torch.apps.calibration.read_gps_info <images> \
        [--out gps.npy]
"""
from __future__ import annotations

import argparse
import math
import os

import numpy as np


def dms_to_deg(dms):
    d, m, s = (float(x) for x in dms)
    return d + m / 60.0 + s / 3600.0


def read_exif_gps(imgname):
    from PIL import Image
    from PIL.ExifTags import GPSTAGS, TAGS

    img = Image.open(imgname)
    exif = img._getexif()
    if not exif:
        return None
    gps = None
    for tag, value in exif.items():
        if TAGS.get(tag) == "GPSInfo":
            gps = {GPSTAGS.get(k, k): v for k, v in value.items()}
    if not gps or "GPSLatitude" not in gps:
        return None
    lat = dms_to_deg(gps["GPSLatitude"])
    lon = dms_to_deg(gps["GPSLongitude"])
    if gps.get("GPSLatitudeRef") == "S":
        lat = -lat
    if gps.get("GPSLongitudeRef") == "W":
        lon = -lon
    alt = float(gps.get("GPSAltitude", 0.0))
    return lat, lon, alt


def gps_to_local_xyz(records):
    """lat/lon/alt -> local metric ENU around the mean position."""
    lats = np.array([r[1][0] for r in records])
    lons = np.array([r[1][1] for r in records])
    alts = np.array([r[1][2] for r in records])
    lat0, lon0 = lats.mean(), lons.mean()
    R_EARTH = 6378137.0
    x = np.deg2rad(lons - lon0) * R_EARTH * math.cos(math.radians(lat0))
    y = np.deg2rad(lats - lat0) * R_EARTH
    z = alts - alts.mean()
    return {r[0]: np.array([xi, yi, zi]) for r, xi, yi, zi in
            zip(records, x, y, z)}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("path", type=str, help="image directory")
    parser.add_argument("--out", type=str, default="gps.npy")
    args = parser.parse_args(argv)
    records = []
    for root, _, files in os.walk(args.path):
        for name in sorted(files):
            if not name.lower().endswith((".jpg", ".jpeg", ".png")):
                continue
            full = os.path.join(root, name)
            gps = read_exif_gps(full)
            if gps is not None:
                rel = os.path.relpath(full, args.path)
                records.append((rel, gps))
    print(f">> found GPS for {len(records)} images")
    if records:
        out = gps_to_local_xyz(records)
        np.save(args.out, out, allow_pickle=True)
        print(f">> wrote {args.out}")


if __name__ == "__main__":
    main()
