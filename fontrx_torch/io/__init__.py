"""Image containers: the QOI encoder and decoder (see ``qoi.py``)."""
