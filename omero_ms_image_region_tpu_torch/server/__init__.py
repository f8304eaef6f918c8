"""HTTP surface: request parsing, settings, the handler and the app."""
