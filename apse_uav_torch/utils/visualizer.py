"""ID-stable track visualisation (numpy drawing, no GUI dependencies).

The port's own copy of the JAX reference's ``utils/visualizer.py``:
persistent per-track colours, labelled boxes and mask overlays drawn into
the frame array.  cv2 is imported only to draw text, and only if present.
"""

from __future__ import annotations

import numpy as np

from apse_uav_torch.utils.mask_geometry import paste_mask_np

_PALETTE = np.asarray(
    [
        (66, 133, 244), (219, 68, 55), (244, 180, 0), (15, 157, 88),
        (171, 71, 188), (0, 172, 193), (255, 112, 67), (158, 157, 36),
        (92, 107, 192), (240, 98, 146), (0, 137, 123), (175, 180, 43),
    ],
    np.uint8,
)


class TrackVisualizer:
    """Draws tracker snapshots with persistent per-id colors."""

    def __init__(self, class_names: tuple[str, ...] = ("car", "truck", "bus", "person")):
        self.class_names = class_names
        self._colors: dict[int, np.ndarray] = {}

    def _color(self, track_id: int) -> np.ndarray:
        if track_id not in self._colors:
            self._colors[track_id] = _PALETTE[len(self._colors) % len(_PALETTE)]
        return self._colors[track_id]

    def draw(self, frame: np.ndarray, recent: dict, mask_alpha: float = 0.4) -> np.ndarray:
        """frame (H, W, 3) uint8 + tracker snapshot -> annotated copy."""
        out = frame.copy()
        h, w = out.shape[:2]
        valid = np.asarray(recent["valid"]).astype(bool)
        for i in np.nonzero(valid)[0]:
            tid = int(recent["ids"][i])
            color = self._color(tid)
            box = np.asarray(recent["boxes"][i])
            x1, y1, x2, y2 = [int(round(float(v))) for v in box]
            x1, x2 = np.clip([x1, x2], 0, w - 1)
            y1, y2 = np.clip([y1, y2], 0, h - 1)
            if "masks" in recent:
                m = paste_mask_np(np.asarray(recent["masks"][i]), box, (h, w))
                out[m] = (out[m] * (1 - mask_alpha) + color * mask_alpha).astype(np.uint8)
            out[y1 : y1 + 2, x1:x2] = color
            out[y2 : y2 + 2, x1:x2] = color
            out[y1:y2, x1 : x1 + 2] = color
            out[y1:y2, x2 : x2 + 2] = color
            label = f"{self.class_names[int(recent['classes'][i]) % len(self.class_names)]} {tid}"
            score = recent.get("scores")
            if score is not None:
                label += f" {float(score[i]):.0%}"
            self._text(out, label, (x1, max(y1 - 4, 10)), color)
        return out

    @staticmethod
    def _text(img: np.ndarray, text: str, org: tuple[int, int], color) -> None:
        try:
            import cv2

            cv2.putText(
                img, text, org, cv2.FONT_HERSHEY_SIMPLEX, 0.5,
                tuple(int(c) for c in color), 1, cv2.LINE_AA,
            )
        except ImportError:
            pass  # drawing text is cosmetic; skip without cv2
