"""Training losses beyond the image loss: the structural priors
(``priors.py``), the distortion loss (``distortion.py``) and nerfacto's
interlevel loss (``interlevel.py``)."""
