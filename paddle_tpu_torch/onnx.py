"""paddle.onnx. reference: paddle_tpu/onnx.py, which raises for `export`
(no exporter there). So does the port's: its portable serialized program
is `jit.save`'s torch.export artifact."""

from __future__ import annotations

__all__ = ["export"]


def export(layer, path, input_spec=None, opset_version=9, **configs):
    raise NotImplementedError(
        "ONNX export is not implemented. For a portable serialized program "
        "use paddle_tpu_torch.jit.save(layer, path, input_spec=...): a "
        "torch.export program with the parameters beside it, which "
        "paddle_tpu_torch.jit.load and inference.create_predictor run")
