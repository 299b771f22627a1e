"""Detection ops in plain PyTorch: box math, exact NMS, ROIAlign."""

from apse_uav_torch.dcnn.ops.boxes import apply_deltas, box_area, box_iou, clip_boxes, get_deltas, nonempty
from apse_uav_torch.dcnn.ops.nms import batched_nms, nms_mask
from apse_uav_torch.dcnn.ops.roi_align import roi_align_hwc

__all__ = ["apply_deltas", "box_area", "box_iou", "clip_boxes", "get_deltas", "nonempty", "batched_nms", "nms_mask",
           "roi_align_hwc"]
