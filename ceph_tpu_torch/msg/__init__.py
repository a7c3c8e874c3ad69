"""Messenger layer (the reference's src/msg capability, SURVEY.md §2.3):
entity-addressed message passing with Dispatcher/Policy semantics.  The
in-proc LocalNetwork transport is the fixture substrate (the reference's
mock/direct messengers); a host gRPC/TCP transport slots behind the same
Messenger API for multi-process (msg.tcp)."""

from .messenger import Connection, Dispatcher, LocalNetwork, Messenger, Policy

__all__ = ["Connection", "Dispatcher", "LocalNetwork", "Messenger", "Policy"]
