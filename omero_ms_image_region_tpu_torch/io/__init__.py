"""Pixel IO: the chunked pyramid store and the image-id service."""
