"""K8, the screened-Poisson solve: ``screened_gradients`` of
``csrc/spectral_dft.cu`` (the tiled passes, or the whole-line kernel on
grids whose lines do not factor into 2, 3, 5 and 7). The work of its
solves is the configuration's (``configs/<config>.py``'s ``work``)."""

PATTERN = r"fft_rows_kernel|fft_cols_kernel|fft_lines_kernel"
