"""CSV I/O byte-compatible with the reference schemas.

* DCNN input CSV: ``Host id: N`` line + header + 17 int columns
  (readCentroidData, aruco_detect.py:105-123).
* ArUco results CSV: 16-column (ArUco only) or 22-column (with DCNN) rows
  (outputDataInit/outputData, aruco_detect.py:125-185) — including the
  reference's exact header strings, zero-fill behavior and str(round(x, n))
  float formatting.
"""

from __future__ import annotations

import csv

import numpy as np

HEADER_WITH_DCNN = (
    "frame_ID ,ID_4_detected ,markerLength ,leds_ID ,UAV_altitude ,fov_width ,fov_height ,"
    "ID_1_detected ,distance_veh1_aruco ,distance_veh1_aruco_bbox ,distance_veh1_dcnn ,distance_veh1_dcnn_bbox ,"
    "ID_2_detected ,distance_veh2_aruco ,distance_veh2_aruco_bbox ,distance_veh2_dcnn ,distance_veh2_dcnn_bbox ,"
    "ID_3_detected ,distance_veh3_aruco ,distance_veh3_aruco_bbox ,distance_veh3_dcnn ,distance_veh3_dcnn_bbox"
)
HEADER_ARUCO_ONLY = (
    "frame_ID ,ID_4_detected ,markerLength ,leds_ID ,UAV_altitude ,fov_width ,fov_height ,"
    "ID_1_detected ,distance_veh1_aruco ,distance_veh1_aruco_bbox ,"
    "ID_2_detected ,distance_veh2_aruco ,distance_veh2_aruco_bbox ,"
    "ID_3_detected ,distance_veh3_aruco ,distance_veh3_aruco_bbox ,"
)


def read_centroid_data(path: str) -> np.ndarray:
    """readCentroidData equivalent: (N, 17) int array; ''/nan -> 0."""
    rows = []
    with open(path) as f:
        for line_count, row in enumerate(csv.reader(f)):
            if line_count <= 1:
                continue
            vals = []
            for i in range(17):
                v = row[i]
                vals.append(0 if v in ("", "nan") else int(v))
            rows.append(vals)
    return np.asarray(rows, dtype=np.int64)


class ResultsWriter:
    """Streaming writer reproducing outputData's row format exactly."""

    def __init__(self, path: str, use_centroid_data: bool):
        self.use_centroid_data = use_centroid_data
        self._f = open(path, "w")
        header = HEADER_WITH_DCNN if use_centroid_data else HEADER_ARUCO_ONLY
        self._f.write(header + "\n")

    def write_frame(self, k: int, out: dict) -> None:
        """out: one frame's scan outputs (host-side python/numpy scalars)."""
        det = [int(x) for x in out["detected"]]
        parts = [str(k), str(det[3])]
        zeros3 = ["0", "0", "0"]
        zeros5 = ["0", "0", "0", "0", "0"]
        if det[3] == 1:
            parts += [
                str(round(float(out["marker_length"]), 5)),
                str(int(out["leds"])),
                str(round(float(out["altitude"]), 2)),
                str(round(float(out["fov_w"]), 2)),
                str(round(float(out["fov_h"]), 2)),
            ]
        else:
            parts += zeros5
        for v in range(3):
            if det[v] == 1:
                row = [
                    str(det[v]),
                    str(round(float(out["dist_aruco"][v]), 3)),
                    str(round(float(out["dist_aruco_bbox"][v]), 3)),
                ]
                if self.use_centroid_data:
                    row += [
                        str(round(float(out["dist_dcnn"][v]), 3)),
                        str(round(float(out["dist_dcnn_bbox"][v]), 3)),
                    ]
                parts += row
            else:
                parts += zeros5 if self.use_centroid_data else zeros3
        self._f.write(",".join(parts) + "\n")
        self._f.flush()  # rows stream out as they're produced (long runs)

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
