"""Upload compression of the port: codecs, error feedback, byte accounting."""
