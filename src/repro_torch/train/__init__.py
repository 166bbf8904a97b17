"""Training state and step builders of the port: the train step (loss,
gradient, optimizer update) and the serving steps."""
