"""Host-side utilities of the port (timing on the card)."""
