"""Model definitions over parameter trees bridged from procyon_tpu."""
