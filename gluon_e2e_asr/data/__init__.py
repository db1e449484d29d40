from gluon_e2e_asr.data.tokenizer import (
    CharTokenizer,
    SubwordTokenizer,
    build_tokenizer,
    tokenizer_from_json,
)
from gluon_e2e_asr.data.manifest import (
    Utterance,
    build_synthetic_manifest,
    load_manifest,
    save_manifest,
    synth_waveform,
)
from gluon_e2e_asr.data.sampler import BucketSampler, BucketSpec
from gluon_e2e_asr.data.loader import Batch, DataLoader
