"""Stage timing and the device trace."""
