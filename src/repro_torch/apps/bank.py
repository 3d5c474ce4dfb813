"""The paper's running example: the bank management system of Figure 1 and
Listing 1, transcribed statement-for-statement into the ``core.lang`` AST."""

from __future__ import annotations

from repro_torch.core.lang import (
    Application,
    Break,
    Call,
    ClassDef,
    Compute,
    COLLECTION,
    ExprStmt,
    FieldSpec,
    ForEach,
    Get,
    If,
    MethodDef,
    Return,
    SetField,
    This,
    Var,
    fields_of,
)


def build_bank_app() -> Application:
    transaction = ClassDef(
        "Transaction",
        fields_of(
            FieldSpec("account", target="Account"),
            FieldSpec("emp", target="Employee"),
            FieldSpec("type", target="TransactionType"),
            FieldSpec("amount"),
        ),
    )
    # public Account getAccount() {
    #   if (this.type.typeID == 1) { this.emp.doSmth(); }
    #   else { this.emp.dept.doSmthElse(); }
    #   return this.account;
    # }
    transaction.add_method(
        MethodDef(
            "getAccount",
            params=(),
            ret_type="Account",
            body=[
                If(
                    cond=Compute(lambda tid: tid == 1, (Get(Get(This(), "type"), "typeID"),), "typeID==1"),
                    then=[ExprStmt(Call(Get(This(), "emp"), "doSmth"))],
                    els=[ExprStmt(Call(Get(Get(This(), "emp"), "dept"), "doSmthElse"))],
                ),
                Return(Get(This(), "account")),
            ],
        )
    )

    ttype = ClassDef("TransactionType", fields_of(FieldSpec("typeID")))

    account = ClassDef("Account", fields_of(FieldSpec("cust", target="Customer"), FieldSpec("balance")))
    # public void setCustomer(Customer newCust) {
    #   if (this.cust.company == newCust.company) { this.cust = newCust; }
    # }
    account.add_method(
        MethodDef(
            "setCustomer",
            params=(("newCust", "Customer"),),
            body=[
                If(
                    cond=Compute(
                        lambda a, b: a == b,
                        (Get(Get(This(), "cust"), "company"), Get(Var("newCust"), "company")),
                        "sameCompany",
                    ),
                    then=[SetField(This(), "cust", Var("newCust"))],
                )
            ],
        )
    )

    customer = ClassDef("Customer", fields_of(FieldSpec("company", target="Company"), FieldSpec("name")))
    company = ClassDef("Company", fields_of(FieldSpec("name")))

    employee = ClassDef("Employee", fields_of(FieldSpec("dept", target="Department"), FieldSpec("name")))
    employee.add_method(MethodDef("doSmth", params=(), body=[ExprStmt(Compute(lambda: None, (), "doSmth"))]))

    department = ClassDef("Department", fields_of(FieldSpec("name")))
    department.add_method(
        MethodDef("doSmthElse", params=(), body=[ExprStmt(Compute(lambda: None, (), "doSmthElse"))])
    )

    bank = ClassDef(
        "BankManagement",
        fields_of(
            FieldSpec("transactions", target="Transaction", card=COLLECTION),
            FieldSpec("manager", target="Customer"),
        ),
    )
    # Read-only traversal over the same navigation chains (used by the
    # accuracy tests: no concurrent mutation of the store).
    bank.add_method(
        MethodDef(
            "auditAll",
            params=(),
            body=[
                ForEach(
                    "trans",
                    This(),
                    "transactions",
                    [
                        ExprStmt(Get(Get(Var("trans"), "type"), "typeID")),
                        ExprStmt(Get(Get(Var("trans"), "emp"), "dept")),
                        ExprStmt(Get(Get(Get(Get(Var("trans"), "account"), "cust"), "company"), "name")),
                    ],
                ),
                ExprStmt(Get(Get(Get(This(), "manager"), "company"), "name")),
            ],
        )
    )
    # public void creditAll(double bonus) {
    #   for (Transaction trans : this.transactions) {
    #     trans.amount = trans.amount + bonus;
    #   }
    # }
    # One unconditional primitive-field write per transaction: the
    # write-dense companion to setAllTransCustomers (whose updates are
    # branch-dependent), used by the write-path accounting tests.
    bank.add_method(
        MethodDef(
            "creditAll",
            params=(("bonus", "double"),),
            body=[
                ForEach(
                    "trans",
                    This(),
                    "transactions",
                    [
                        SetField(
                            Var("trans"),
                            "amount",
                            Compute(
                                lambda a, b: a + b,
                                (Get(Var("trans"), "amount"), Var("bonus")),
                                "plusBonus",
                            ),
                        )
                    ],
                )
            ],
        )
    )
    # public void findLargeTransaction(double floor) {
    #   for (Transaction trans : this.transactions) {
    #     if (trans.amount >= floor) { trans.account.cust; break; }
    #   }
    # }
    # An early-exit scan: the break taints the loop, so the static
    # optimizer's partial-traversal pass marks the transactions[] hint with
    # a prefix bound instead of predicting the whole collection.
    bank.add_method(
        MethodDef(
            "findLargeTransaction",
            params=(("floor", "double"),),
            body=[
                ForEach(
                    "trans",
                    This(),
                    "transactions",
                    [
                        If(
                            cond=Compute(
                                lambda a, f: a >= f,
                                (Get(Var("trans"), "amount"), Var("floor")),
                                "overFloor",
                            ),
                            then=[
                                ExprStmt(Get(Get(Var("trans"), "account"), "cust")),
                                Break(),
                            ],
                        )
                    ],
                )
            ],
        )
    )
    # public void setAllTransCustomers() {
    #   for (Transaction trans : this.transactions) {
    #     trans.getAccount().setCustomer(this.manager);
    #   }
    # }
    bank.add_method(
        MethodDef(
            "setAllTransCustomers",
            params=(),
            body=[
                ForEach(
                    "trans",
                    This(),
                    "transactions",
                    [
                        ExprStmt(
                            Call(
                                Call(Var("trans"), "getAccount"),
                                "setCustomer",
                                (Get(This(), "manager"),),
                            )
                        )
                    ],
                )
            ],
        )
    )

    return Application(
        name="bank",
        classes={
            c.name: c
            for c in [transaction, ttype, account, customer, company, employee, department, bank]
        },
    )


def populate_bank_store(store, n_transactions: int = 100, n_companies: int = 3, seed: int = 0):
    """Store a bank dataset; returns the BankManagement root oid."""
    import random

    rng = random.Random(seed)
    companies = [store.put("Company", {"name": f"co{i}"}) for i in range(n_companies)]
    manager_co = companies[0]
    manager = store.put("Customer", {"company": manager_co, "name": "manager"})
    depts = [store.put("Department", {"name": f"dept{i}"}) for i in range(4)]
    ttypes = [store.put("TransactionType", {"typeID": i}) for i in (1, 2)]
    transactions = []
    for i in range(n_transactions):
        comp = rng.choice(companies)
        # each transaction's navigation closure (tx -> account -> customer,
        # tx -> employee) is one locality group: a locality-aware placement
        # co-locates the whole hop chain on one Data Service
        cust = store.put("Customer", {"company": comp, "name": f"cust{i}"}, group=f"tx{i}")
        acct = store.put("Account", {"cust": cust, "balance": float(i)}, group=f"tx{i}")
        emp = store.put("Employee", {"dept": rng.choice(depts), "name": f"emp{i}"}, group=f"tx{i}")
        tx = store.put(
            "Transaction",
            {"account": acct, "emp": emp, "type": rng.choice(ttypes), "amount": float(i)},
            group=f"tx{i}",
        )
        transactions.append(tx)
    root = store.put("BankManagement", {"transactions": transactions, "manager": manager})
    return root
