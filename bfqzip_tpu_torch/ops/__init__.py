"""Device compute of the port: scans, suffix build, smoothing, inversion."""
