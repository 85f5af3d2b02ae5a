from .network_gui import NetworkGUI, ViewerRequest  # noqa: F401
