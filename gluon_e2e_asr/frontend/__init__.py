from gluon_e2e_asr.frontend.features import (
    compute_features,
    frontend_apply,
    num_frames,
    mel_filterbank,
    dft_basis,
)
