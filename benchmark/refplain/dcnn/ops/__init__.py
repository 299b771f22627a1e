"""Detection ops in plain PyTorch: box math, exact NMS, the ROIAlign sample grid."""

from refplain.dcnn.ops.boxes import apply_deltas, box_area, box_iou, clip_boxes, nonempty
from refplain.dcnn.ops.nms import batched_nms, nms_mask

__all__ = ["apply_deltas", "box_area", "box_iou", "clip_boxes", "nonempty", "batched_nms", "nms_mask"]
