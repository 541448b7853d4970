"""Entry points of the port: the service bootstrap and the data-manager
service."""
