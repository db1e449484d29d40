from gluon_e2e_asr.models.encoder import BiLSTMEncoder
from gluon_e2e_asr.models.decoder import AttentionDecoder
from gluon_e2e_asr.models.asr import ASRModel, build_model
