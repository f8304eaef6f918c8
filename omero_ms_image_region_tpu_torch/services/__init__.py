"""Metadata and ACL services."""
