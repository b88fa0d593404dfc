"""FAT quantization core: specs, calibration observers, the quant context,
folding and equalization, the distillation loss.

  QuantSpec / fake_quant_* / quantize_*        (quant.py: §2, §3.1, §4.2)
  init_observer / update_observer / ...        (calibration.py: §2)
  QuantPolicy / QuantCtx / init_qparams / ...  (api.py: integration)
  fold_batchnorm / fold_model_norms            (folding.py: §3.1.2)
  dws_relu6_rescale / pair_rescale / ...       (equalization.py: §3.3)
  chunked_sq_err / chunked_ce_loss             (distill.py: §3.2)
"""
from repro_torch.core.quant import (
    QuantSpec,
    ste_round,
    fake_quant_symmetric,
    fake_quant_asymmetric,
    quantize_weights_int8,
    quantize_bias_int32,
    apply_pointwise_scale,
    max_abs_threshold,
    min_max_threshold,
    adjusted_threshold,
)
from repro_torch.core.calibration import (
    init_observer,
    update_observer,
    observer_thresholds,
)
from repro_torch.core.api import (
    QuantPolicy,
    QuantCtx,
    make_ctx,
    init_qparams,
    finalize_calibration,
    trainable_mask,
    convert_to_int8,
)
from repro_torch.core.folding import fold_batchnorm, fold_model_norms
from repro_torch.core.equalization import (
    dws_relu6_rescale,
    pair_rescale,
    equalize_model,
)
from repro_torch.core.distill import chunked_sq_err, chunked_ce_loss
