from gluon_e2e_asr.ops.ctc import ctc_loss, ctc_forward_alpha
from gluon_e2e_asr.ops.losses import (
    ce_label_smoothing_loss,
    hybrid_loss,
    make_decoder_io,
)
