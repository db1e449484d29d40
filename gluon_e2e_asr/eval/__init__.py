from gluon_e2e_asr.eval.metrics import edit_distance, wer, cer
