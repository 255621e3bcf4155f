"""Stage timing and the device trace, the user cache directory and
downloads."""
