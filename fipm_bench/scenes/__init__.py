"""Scene generators (one module per `scene` name in a configuration) and
the PNG writer. numpy and scipy only."""
