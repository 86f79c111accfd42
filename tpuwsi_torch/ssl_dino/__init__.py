"""DINO self-supervised training (``tpuwsi/ssl_dino``)."""
