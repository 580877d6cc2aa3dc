"""Data layer: the real-noise bank (device crops, the native host crop
server and its prefetching feed), the GWTC catalog, SNR regimes and
dataset I/O. Port of posteriflow_tpu/data/."""

from posteriflow_torch.data.noise_bank import (NoiseBank, RealNoiseDraws,
                                               draw_real_noise,
                                               load_noise_bank,
                                               make_synthetic_bank,
                                               real_noise_from_draws,
                                               recolor_signal,
                                               sample_real_noise,
                                               save_bank_segment)

__all__ = ["NoiseBank", "load_noise_bank", "make_synthetic_bank",
           "sample_real_noise", "recolor_signal", "save_bank_segment",
           "RealNoiseDraws", "draw_real_noise", "real_noise_from_draws"]
