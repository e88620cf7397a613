from cvo_rgbd_tpu.ops.moment_kernel import fused_moments, fused_wsq

__all__ = ["fused_moments", "fused_wsq"]
