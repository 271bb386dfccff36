"""CodedFedL core of the port: delay model, allocation, RFF, encoding,
aggregation, schemes and the round loop (see ``repro.core``)."""
