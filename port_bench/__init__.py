"""The benchmark of `ideal_gan_tpu_torch` on the card (see README.md)."""
