"""Neural models: the on-device 2D keypoint detector for the fully-fused
end-to-end variant (images -> heatmaps -> keypoints -> 3D fusion in one XLA
program). The reference runs its 2D CNN on external EdgeTPU sensor boards
(README.md:7-11) and this repo's pipeline normally ingests their detections;
this package brings an equivalent detector onto the accelerator."""
