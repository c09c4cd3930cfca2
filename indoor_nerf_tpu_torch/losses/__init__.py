"""Training losses beyond the image loss: the structural priors
(``priors.py``) and the distortion loss (``distortion.py``)."""
