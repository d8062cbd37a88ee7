"""The PTA gravitational-wave path (pint_tpu gw/): overlap-reduction
functions, the kron-structured common-process likelihood and the
optimal statistic."""
