"""Pretrained inference interfaces of the port."""
