"""Build helpers of the port."""
