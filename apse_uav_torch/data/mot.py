"""MOT17/20 and KITTI-MOTS loaders for association-head training.

Counterparts of the JAX reference's ``data/mot.py`` (MOTloader / MOTSloader
and RoiFeaturesGenerator of the original code): parse a sequence's ground
truth, run its frames through the frozen backbone, pool one ROI feature per
GT object, and pack (ids, rois) batches of consecutive frames for the
triplet loss.  The backbone is the port's ``MaskRCNN.features`` under
``no_grad``; masks decode through the port's RLE codec; PIL reads frames and
resizes masks, as in the reference.
"""

from __future__ import annotations

import configparser
import math
import os
from os.path import join

import numpy as np
import torch

from apse_uav_torch.dcnn.ops.roi_align import roi_align, roi_pool


class RoiFeaturesGenerator:
    """Backbone-only ROI features (roi_features_generator.py:24-130).

    ``model`` is the port's MaskRCNN (its ``features``, frozen); frames come
    as (H, W, 3) float32 BGR numpy arrays and go to the model's device."""

    def __init__(self, model, roi_size: int = 8, feature_key: str = "p2"):
        self.model = model
        self.roi_size = roi_size
        self.feature_key = feature_key

    @torch.no_grad()
    def get_rois_features(self, frame: np.ndarray, objects: np.ndarray, masks: list | None = None):
        """frame (H, W, 3); objects rows ``frame,id,x,y,w,h,...`` (MOT gt) ->
        (ids (N,) int64, rois (N, C, R, R) float32 numpy).

        With ``masks`` (full-image binary, MOTS) the feature map is multiplied
        by each mask resized to it, then ROIAligned (4 samples a bin, not
        aligned); without, ROIPool on the GT boxes (roi_features_generator.py:94-113)."""
        dev = self.model.pixel_mean.device
        feats = self.model.features(torch.from_numpy(np.ascontiguousarray(frame[None], np.float32)).to(dev))
        feat = feats[self.feature_key][0]  # (h, w, C)
        h, w = frame.shape[:2]
        fh, fw = feat.shape[:2]
        scale = fw / w
        ids = objects[:, 1].astype(np.int64)
        boxes = objects[:, 2:6].astype(np.float32).copy()
        boxes[:, 2:] += boxes[:, :2]  # xywh -> xyxy
        cfeat = feat.permute(2, 0, 1)  # (C, h, w)
        tboxes = torch.from_numpy(boxes).to(dev)
        if masks is not None:
            lowres = torch.from_numpy(np.stack([_resize_mask(m, (fh, fw)) for m in masks])).to(dev)
            rois = torch.cat([roi_align(cfeat * lowres[i], tboxes[i:i + 1], self.roi_size, scale, 4, False)
                              for i in range(len(masks))])
        else:
            rois = roi_pool(cfeat, tboxes, self.roi_size, scale)
        return ids, rois.cpu().numpy()


def _resize_mask(mask: np.ndarray, hw: tuple[int, int]) -> np.ndarray:
    """A binary mask resized to (h, w) by PIL's bilinear filter on 0/255, as a [0, 1] float32 map."""
    from PIL import Image

    return np.asarray(Image.fromarray((mask * 255).astype(np.uint8)).resize((hw[1], hw[0]), Image.BILINEAR),
                      np.float32) / 255.0


def _read_frame(path: str) -> np.ndarray:
    """An image file as (H, W, 3) float32 BGR."""
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"))[..., ::-1].astype(np.float32)


class MOTLoader:
    """A MOT17/20 sequence (MOT_utils.py:25-119)."""

    def __init__(self, sequence_path: str, roi_generator: RoiFeaturesGenerator, frames_in_batch: int = 8):
        self.sequence_path = sequence_path
        self.frames_in_batch = frames_in_batch
        self.roi_generator = roi_generator
        self.sequence_info = self._read_seqinfo()
        self.frames_in_sequence = int(self.sequence_info["seqLength"])
        self.num_of_batches = math.floor(self.frames_in_sequence / frames_in_batch)
        self.sequence_objects = self._gt_instances()

    def _read_seqinfo(self) -> dict:
        cp = configparser.ConfigParser()
        cp.read(join(self.sequence_path, "seqinfo.ini"))
        return dict(cp["Sequence"]) | {"seqLength": cp["Sequence"]["seqlength"]}

    def _gt_instances(self) -> np.ndarray:
        rows = []
        with open(join(self.sequence_path, "gt", "gt.txt")) as f:
            for line in f:
                rows.append([int(float(v)) for v in line.strip().split(",")[:7]])
        inst = np.asarray(rows)
        return inst[inst[:, 6] == 1]  # confident GT only (MOT_utils.py:71)

    def frame_image(self, frame_number: int) -> np.ndarray:
        return _read_frame(join(self.sequence_path, "img1", f"{frame_number:06d}.jpg"))

    def get_training_batch(self, batch_idx: int):
        assert batch_idx < self.num_of_batches
        all_ids, all_rois = [], []
        for k in range(self.frames_in_batch):
            frame_number = (k + 1) + batch_idx * self.frames_in_batch
            objs = self.sequence_objects[self.sequence_objects[:, 0] == frame_number]
            if len(objs) == 0:
                continue
            ids, rois = self.roi_generator.get_rois_features(self.frame_image(frame_number), objs)
            all_ids.append(ids)
            all_rois.append(rois)
        if not all_ids:
            return np.zeros(0, np.int64), np.zeros((0,), np.float32)
        return np.concatenate(all_ids), np.concatenate(all_rois)


class MOTSLoader:
    """KITTI-MOTS: one RLE instance txt per sequence (MOT_utils.py:123-264)."""

    def __init__(self, instances_txt_folder: str, image_folder: str, seq_names: list[str],
                 roi_generator: RoiFeaturesGenerator, frames_in_batch: int = 4):
        from apse_uav_torch.evaluation.mots import load_txt

        self.image_folder = image_folder
        self.roi_generator = roi_generator
        self.frames_in_batch = frames_in_batch
        self.sequences = {seq: load_txt(join(instances_txt_folder, seq + ".txt")) for seq in seq_names}
        # Frames that carry annotations, per sequence.
        self.annotated_frames = {seq: sorted(f for f, objs in frames.items() if objs)
                                 for seq, frames in self.sequences.items()}

    def num_batches(self, seq: str) -> int:
        return math.floor(len(self.annotated_frames[seq]) / self.frames_in_batch)

    def frame_image(self, seq: str, frame: int) -> np.ndarray:
        p = join(self.image_folder, seq, f"{frame:06d}.png")
        if not os.path.exists(p):
            p = join(self.image_folder, seq, f"{frame:06d}.jpg")
        return _read_frame(p)

    def get_training_batch(self, seq: str, batch_idx: int):
        """Consecutive annotated frames -> (ids, rois) (MOT_utils.py:238-264)."""
        from apse_uav_torch.evaluation import rle as rletools

        frames = self.annotated_frames[seq][batch_idx * self.frames_in_batch:(batch_idx + 1) * self.frames_in_batch]
        all_ids, all_rois = [], []
        for f in frames:
            objs = [o for o in self.sequences[seq][f] if o.class_id in (1, 2)]
            if not objs:
                continue
            img = self.frame_image(seq, f)
            masks = [rletools.decode(o.mask) for o in objs]
            rows = []
            for o in objs:
                x, y, w, h = rletools.toBbox(o.mask)
                rows.append([f, o.track_id, x, y, w, h, 1])
            ids, rois = self.roi_generator.get_rois_features(img, np.asarray(rows), masks=masks)
            all_ids.append(ids)
            all_rois.append(rois)
        if not all_ids:
            return np.zeros(0, np.int64), np.zeros((0,), np.float32)
        return np.concatenate(all_ids), np.concatenate(all_rois)
