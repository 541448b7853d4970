"""Entry-point helpers of the port (the engine half of the service
bootstrap)."""
