"""Association-head embedding check on the PyTorch port (association_head_test.py equivalent).

Flags are those of the JAX reference's ``cli/association_head_test.py``,
plus ``--device cuda|cpu`` (``cuda`` raises when no card is visible, never
falls back).  Picks a GT track id on the first frame of a MOT sequence, then
prints per-frame embedding distances from that anchor to every GT instance:
the anchor's own track should be the closest.  ``--assoc_weights`` reads the
port's checkpoint (``directory/name``, e.g. ``workdir/epoch_9``; a reference
checkpoint converts through ``convert.checkpoint_state``), as
``tracker_test`` does; without it the head is the reference's default
(its flax init under ``PRNGKey(1)``).

Usage:
    python -m apse_uav_torch.cli.association_head_test --sequence MOT17-02 \
        --weights model_final.pth --assoc_weights runs/assoc/epoch_9
"""

from __future__ import annotations

import argparse

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--sequence", required=True, help="MOT sequence dir (img1/, gt/, seqinfo.ini)")
    p.add_argument("--weights", required=True, help="detector checkpoint for the frozen backbone")
    p.add_argument("--assoc_weights", default=None, help="association head checkpoint (the port's format)")
    p.add_argument("--track_id", type=int, default=None, help="anchor GT id (default: first)")
    p.add_argument("--frames", type=int, default=10)
    p.add_argument("--depth", type=int, default=101, choices=(50, 101))
    p.add_argument("--roi_size", type=int, default=8)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda (default; raises when no card is visible) or cpu (plain PyTorch path)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import torch

    from apse_uav_torch.cli.track_uav import cli_device
    from apse_uav_torch.cli.train_association_head import frozen_backbone
    from apse_uav_torch.data.mot import MOTLoader, RoiFeaturesGenerator
    from apse_uav_torch.dcnn.models.association import AssociationHead, head_weights

    device = cli_device(args)
    model, cfg = frozen_backbone(args, device)
    loader = MOTLoader(args.sequence, RoiFeaturesGenerator(model, roi_size=args.roi_size), frames_in_batch=1)
    in_dim = cfg.fpn_channels * args.roi_size**2
    head = AssociationHead(in_dim)
    head.load_state_dict({k: torch.as_tensor(v) for k, v in head_weights(args.assoc_weights, in_dim).items()})
    head = head.to(device).eval()

    def embed(rois):
        with torch.no_grad():
            return head(torch.from_numpy(rois).to(device)).cpu().numpy()

    # The anchor embedding, from frame 1.
    ids0, rois0 = loader.get_training_batch(0)
    anchor_id = args.track_id if args.track_id is not None else int(ids0[0])
    if anchor_id not in ids0:
        raise SystemExit(f"track id {anchor_id} not on frame 1 (ids: {sorted(set(ids0))})")
    anchor = embed(rois0)[list(ids0).index(anchor_id)]
    correct = total = 0
    for f in range(1, min(args.frames, loader.num_of_batches)):
        ids, rois = loader.get_training_batch(f)
        if len(ids) == 0:
            continue
        d = np.linalg.norm(embed(rois) - anchor[None], axis=1)
        order = np.argsort(d)
        line = ", ".join(f"id {ids[i]}: {d[i]:.3f}" for i in order[:5])
        nearest = ids[order[0]]
        mark = "OK" if nearest == anchor_id else "MISS"
        if anchor_id in ids:
            total += 1
            correct += int(nearest == anchor_id)
        print(f"frame {f + 1} [{mark}]: {line}")
    if total:
        print(f"anchor id {anchor_id}: nearest-neighbor accuracy {correct}/{total}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
