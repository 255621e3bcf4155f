"""Edge sender: streams JPEG frames to the server."""
