"""Host (NumPy) DSP front-ends of the port (counterpart of codec_tpu/dsp)."""

from .audio import (  # noqa: F401
    hann_periodic,
    hann_symmetric,
    mel_filter_bank,
    povey_window,
    slaney_mel_filterbank,
    w2v_bert_features,
    whisper_log_mel,
)
