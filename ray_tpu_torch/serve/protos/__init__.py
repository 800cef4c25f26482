"""Generated + source proto contracts for the Serve gRPC ingress."""
