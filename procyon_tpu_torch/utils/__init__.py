"""Host-side utilities of the port: timing on the card, the estimated
A100 denominators, profiling and trace tables."""
