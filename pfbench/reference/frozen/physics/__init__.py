"""Physical constants and the numpy design PSDs that `prepare_real` needs."""
