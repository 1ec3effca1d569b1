"""PyTorch/CUDA port of `yolo_series_tpu` for NVIDIA Hopper (H100).

The JAX package beside this one is the reference; every module here names
its JAX counterpart and is tested against it on the same inputs. This
package imports torch, numpy and yaml only — never jax and never a module
of `yolo_series_tpu`.

Scope so far: the yolov7 deploy serving path (`infer.serving`), with
hand-written CUDA kernels (`csrc/`) for the NMS keep-mask, the fused stem
tail and the fused ELAN span.
"""
