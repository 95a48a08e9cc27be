"""Post-training int8 quantization (PTQ) for serving (counterpart of the JAX
package's ``quant/``).

The calibrate -> sweep -> serve workflow:

* ``calibrate.py`` — per-channel symmetric int8 weight scales (numpy over
  the flax-layout view of the weights, so the artifact is bit-identical to
  the JAX package's) plus the activation range of the cls/reg input from a
  small calibration sweep through the inference forward.
* ``sensitivity.py`` — the arXiv:1806.00370 per-layer-group sweep:
  fake-quantize one group at a time, measure response-reconstruction error
  (and optionally a mAP delta), plan int8 or bf16 per group.
* ``artifact.py`` — the ``quant_artifact/v1`` sidecar: JSON with a CRC32
  per scale, written atomically, byte-compatible with the JAX package's.
* ``apply.py`` — the resident int8 tree the serving engine keeps on the
  device, and the per-call reconstruction through the grouped dequantize
  kernel (one launch per call).
"""

from replication_faster_rcnn_tpu_torch.quant.artifact import (  # noqa: F401
    ARTIFACT_SCHEMA,
    QuantArtifactError,
    default_artifact_path,
    load_artifact,
    save_artifact,
)
from replication_faster_rcnn_tpu_torch.quant.calibrate import (  # noqa: F401
    EMBED_RANGE_KEY,
    QUANT_DENSE_PATHS,
    calibrate,
    dataset_calibration_batches,
    layer_group_of,
    quantizable,
    synthetic_calibration_batches,
    weight_scales,
)
from replication_faster_rcnn_tpu_torch.quant.apply import (  # noqa: F401
    build_infer_variables,
    fake_quant_variables,
    quantize_variables,
    quantized_params_bytes,
    round_trip_errors,
    synthetic_artifact,
)
from replication_faster_rcnn_tpu_torch.quant.sensitivity import (  # noqa: F401
    response_reconstruction_error,
    sweep,
)
