from .node import (
    ChangeSignal, GEOMETRY, MATERIAL, NodeBase, Node, Primitive, Observer,
    World, print_scenegraph, BridgeNode,
)

__all__ = [
    "ChangeSignal", "GEOMETRY", "MATERIAL", "NodeBase", "Node", "Primitive",
    "Observer", "World", "print_scenegraph", "BridgeNode",
]
