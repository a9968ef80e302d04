"""Offline design tools of the port: GP hyperparameter fitting (``mle``),
the closed-loop Lipschitz constant (``lipschitz``), terminal-set synthesis
(``terminal_set``), the finite-sample calculators (``sample_complexity``,
``num_of_samples``) and the closed-loop goldens (``goldens``).  None of
them imports matplotlib at import time."""
