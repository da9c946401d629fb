"""FFTs, the Coulomb kernel, pivoted Cholesky, the ridge solver."""
