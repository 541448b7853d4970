"""Anonymizer: scrub personal data from ticket text before indexing.

Copy of ``archi_tpu/data/collectors/anonymizer.py``.

Mirrors the reference's ``Anonymizer``
(``src/data_manager/collectors/utils/anonymizer.py:13``), which combines
spaCy PERSON-NER with regexes and config-driven greeting/sign-off
stripping.  spaCy is not in this image, so the NER stage here is a
**rule + gazetteer person detector** (``PersonNER``) instead of a
statistical model:

- a ~300-entry given-name gazetteer (capitalized gazetteer token →
  person, with last-name propagation: once "John Smith" is found,
  bare "Smith" is scrubbed too);
- salutation/sign-off/field triggers ("Dear X", "Thanks, X",
  "From: X", "Reported by X", "cc X") accept capitalized sequences the
  gazetteer doesn't know;
- email local-part mining: j.smith@… marks "Smith"/"J. Smith"
  elsewhere in the text;
- ticket-author seeding: ``anonymize_ticket`` scrubs the structured
  author/assignee/reporter fields outright and feeds those names into
  the text pass (the tracker metadata already tells us who the humans
  are — the strongest possible NER signal).

Precision/recall of the person stage is MEASURED on a labeled fixture in
``tests/unit/test_anonymizer_ner.py`` (printed + asserted there), not
assumed.  Regex classes (emails, phones, @handles) are kept from the
previous round.
"""

from __future__ import annotations

import re
from typing import Iterable, Sequence

_EMAIL = re.compile(r"[\w.+-]+@[\w-]+\.[\w.-]+")
_PHONE = re.compile(r"(?<!\d)(?:\+?\d{1,3}[ .-]?)?(?:\(\d{2,4}\)[ .-]?)?\d{3,4}[ .-]\d{3,4}(?:[ .-]\d{2,4})?(?!\d)")
_HANDLE = re.compile(r"(?<!\w)@[A-Za-z0-9_]{2,}")

# Common given names (gazetteer core).  Deliberately first names only:
# surnames are learned per-text by propagation from full-name matches and
# email local parts, which keeps the static list small and precision high.
_GIVEN_NAMES = frozenset("""
james john robert michael william david richard joseph thomas charles
christopher daniel matthew anthony mark donald steven paul andrew joshua
kenneth kevin brian george timothy ronald edward jason jeffrey ryan jacob
gary nicholas eric jonathan stephen larry justin scott brandon benjamin
samuel gregory frank alexander raymond patrick jack dennis jerry tyler
aaron jose adam nathan henry douglas zachary peter kyle ethan walter noah
jeremy christian keith roger terry gerald harold sean austin carl arthur
lawrence dylan jesse jordan bryan billy joe bruce gabriel logan albert
willie alan juan wayne elijah randy roy vincent ralph eugene russell
bobby mason philip louis mary patricia jennifer linda elizabeth barbara
susan jessica sarah karen lisa nancy betty margaret sandra ashley
kimberly emily donna michelle carol amanda dorothy melissa deborah
stephanie rebecca sharon laura cynthia kathleen amy angela shirley anna
brenda pamela emma nicole helen samantha katherine christine debra
rachel carolyn janet catherine maria heather diane ruth julie olivia
joyce virginia victoria kelly lauren christina joan evelyn judith megan
andrea cheryl hannah jacqueline martha gloria teresa ann sara madison
frances kathryn janice jean abigail alice julia judy sophia grace denise
amber doris marilyn danielle beverly isabella theresa diana natalie
brittany charlotte marie kayla alexis lori pietro hasan luca giulia
marco paolo andrea stefan andreas hans klaus jurgen wolfgang dieter
pierre jean-pierre francois michel alain philippe laurent olivier
antoine camille amelie sophie marine claire elena sergey dmitry ivan
alexei olga natasha svetlana tatiana wei ming hua jing li chen yuki
hiroshi takashi kenji akira raj priya amit sanjay vikram anil sunil
deepak rahul arjun carlos miguel javier alejandro diego fernando pablo
sergio ricardo eduardo luis ana lucia carmen isabel rosa pedro joao
tiago rui nuno fatima ahmed mohammed ali omar hassan ibrahim youssef
khalid tarek samir leila yasmin aisha zainab
""".split())

# Capitalized tokens that are NOT person evidence even mid-sentence:
# calendar terms, common sentence-internal words, and the tech/physics
# vocabulary of the reference's domain (CERN ops tickets).
_EXCLUDED = frozenset("""
monday tuesday wednesday thursday friday saturday sunday january
february march april may june july august september october november
december the this that these those a an i we you they he she it please
note see also new old best regards thanks thank dear hi hello cheers
sincerely kind yours ok yes no later today tomorrow yesterday after
before during meanwhile however finally subject re fwd
monte carlo cern cms atlas lhc
lhcb fermilab desy slac grid condor htcondor kubernetes docker podman
linux ubuntu centos debian fedora windows python java scala rust
postgres postgresql mysql sqlite redis kafka spark hadoop tensorflow
pytorch jax numpy scipy pandas jira redmine github gitlab jenkins
grafana prometheus apache nginx flask django react angular geneva
zurich amsterdam chicago london paris europe america asia error warning
failed failure job jobs queue queues node nodes cluster clusters server
servers disk memory cpu gpu tpu http https ssl tls ssh ftp api rest
json yaml xml html css sql url uri uuid id
""".split())

# context that promotes an unknown capitalized sequence to a person
_TRIGGER_WORDS = frozenset(
    "dear hi hello hey thanks regards best cheers sincerely cc fyi ping "
    "from to by signed attn".split())
_TRIGGER = re.compile(
    r"(?:\b(?:dear|hi|hello|hey|thanks|thank you|regards|best|cheers|"
    r"sincerely|cc|fyi|ping|from|to|by|reported by|assigned to|"
    r"submitted by|created by|signed|authored by|attn)\b[:,]?\s+)$",
    re.IGNORECASE)

_CAP_SEQ = re.compile(r"\b([A-Z][a-z]+(?:[ \t]+[A-Z][a-z]+)*)\b")
_INITIAL_NAME = re.compile(r"\b([A-Z]\.\s*[A-Z][a-z]{2,})\b")


def _email_name_parts(text: str) -> set[str]:
    """j.smith@x / john_smith@x / jsmith27@x → {'smith', 'john'}."""
    parts: set[str] = set()
    for m in _EMAIL.finditer(text):
        local = m.group(0).split("@", 1)[0]
        for p in re.split(r"[^A-Za-z]+", local):
            if len(p) >= 3 and p.lower() not in _EXCLUDED:
                parts.add(p.lower())
    return parts


class PersonNER:
    """Rule + gazetteer person-mention detector (spaCy-PERSON stand-in)."""

    def __init__(self, *, excluded_words: Iterable[str] = (),
                 extra_names: Iterable[str] = ()):
        self.excluded = _EXCLUDED | {w.lower() for w in excluded_words}
        self.gazetteer = _GIVEN_NAMES | {n.lower() for n in extra_names}

    def find_persons(self, text: str,
                     known_names: Iterable[str] = ()) -> set[str]:
        """→ the set of person-mention strings found in ``text``.

        known_names: externally-known person names (ticket author
        fields); matched case-insensitively, and their tokens join the
        session gazetteer.
        """
        session_names = set(self.gazetteer)
        for n in known_names:
            for tok in re.split(r"[^A-Za-z]+", n):
                if len(tok) >= 2 and tok.lower() not in self.excluded:
                    session_names.add(tok.lower())
        session_names |= _email_name_parts(text)

        found: set[str] = set()
        surnames: set[str] = set()

        def accept(seq: str) -> None:
            found.add(seq)
            toks = seq.split()
            if len(toks) >= 2:
                # last-name propagation: "John Smith" → bare "Smith"
                # (and bare "John") elsewhere is the same person
                for t in toks:
                    if t.lower() not in self.excluded:
                        surnames.add(t.lower())

        trim = self.excluded | _TRIGGER_WORDS
        for m in _CAP_SEQ.finditer(text):
            seq = re.sub(r"\s+", " ", m.group(1))
            toks = seq.split()
            low = [t.lower() for t in toks]
            # a capitalized trigger/filler absorbed into the sequence
            # ("Ping Takashi", "Later Carlos Mendes") both hides the
            # trigger context and pollutes the mention — trim edges
            # first, remembering if a trimmed lead word WAS a trigger
            context = _TRIGGER.search(text[: m.start()]) is not None
            while low and low[0] in trim:
                context = context or low[0] in _TRIGGER_WORDS
                toks.pop(0), low.pop(0)
            while low and low[-1] in trim:
                toks.pop(), low.pop()
            if not toks or all(t in self.excluded for t in low):
                continue
            in_gaz = any(t in session_names for t in low)
            if in_gaz or (context and len(low) <= 3):
                accept(" ".join(toks))

        # second pass: bare surnames / gazetteer singles made known by the
        # first pass ("Smith restarted the job", "as Smith suggested")
        if surnames:
            for m in _CAP_SEQ.finditer(text):
                seq = re.sub(r"\s+", " ", m.group(1))
                if seq in found:
                    continue
                if all(t.lower() in surnames for t in seq.split()):
                    found.add(seq)

        # "J. Smith" initial forms — the initial+capitalized shape is
        # itself strong person evidence (spaCy tags these PERSON too)
        for m in _INITIAL_NAME.finditer(text):
            last = m.group(1).split()[-1].lower()
            if last not in self.excluded:
                found.add(m.group(1))
                surnames.add(last)
        return found


class Anonymizer:
    """Regex + PersonNER scrubbing; ``[REDACTED]`` placeholders."""

    def __init__(self, placeholder: str = "[REDACTED]", *,
                 excluded_words: Iterable[str] = (),
                 extra_names: Iterable[str] = ()):
        self.placeholder = placeholder
        self.ner = PersonNER(excluded_words=excluded_words,
                             extra_names=extra_names)

    def anonymize(self, text: str,
                  known_persons: Iterable[str] = ()) -> str:
        persons = self.ner.find_persons(text, known_names=known_persons)
        # longest-first so "John Smith" is replaced before bare "Smith"
        for name in sorted(persons, key=len, reverse=True):
            text = re.sub(r"\b" + re.escape(name) + r"\b",
                          self.placeholder, text)
        for name in known_persons:
            if name.strip():
                text = re.sub(re.escape(name), self.placeholder, text,
                              flags=re.IGNORECASE)
        text = _EMAIL.sub(self.placeholder, text)
        text = _PHONE.sub(self.placeholder, text)
        text = _HANDLE.sub(self.placeholder, text)
        return text

    _AUTHOR_FIELDS = ("author", "assignee", "reporter", "assigned_to",
                      "created_by", "user", "owner", "watchers")

    def anonymize_ticket(self, fields: dict) -> dict:
        """Scrub a structured ticket: author-class fields are replaced
        outright, and their values seed the NER pass over text fields —
        the reference feeds tracker tickets through its anonymizer the
        same way (``ticket_manager.py`` optional anonymization)."""
        known: list[str] = []
        for f in self._AUTHOR_FIELDS:
            v = fields.get(f)
            if isinstance(v, str) and v.strip():
                known.append(v)
            elif isinstance(v, list):
                known.extend(x for x in v if isinstance(x, str))
        out = {}
        for key, v in fields.items():
            if key in self._AUTHOR_FIELDS:
                out[key] = (self.placeholder if isinstance(v, str)
                            else [self.placeholder] * len(v)
                            if isinstance(v, list) else v)
            elif isinstance(v, str):
                out[key] = self.anonymize(v, known_persons=known)
            else:
                out[key] = v
        return out
