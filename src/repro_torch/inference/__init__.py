"""Serving engine and token sampling."""
