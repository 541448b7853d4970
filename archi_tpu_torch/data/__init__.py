"""The data plane of the data-manager service: catalog, persistence,
collectors, chunking, the diff sync into the port's store, and the
scheduler."""
